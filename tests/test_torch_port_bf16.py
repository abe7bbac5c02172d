"""The port's bf16 path against the JAX package's, on the CPU.

Weights: ``init_params`` (seed 0) carried to flax (``to_flax``), with the
fuse convs biased so that both hands are plausible (``visible_hands``).
Inputs from numpy seeds. JAX is built canonical (no s2d rewrites, no
merged heads), the network the port builds. Tolerances, each stated
where it is asserted:
- the blocks in bf16: one bf16 rounding of the output scale;
- ACRNet's maps at 64 px: mean relative error against JAX's bf16 maps
  below 2e-3 for the heads' maps (measured at most 2.3e-4) and below
  0.03 for the segm logits (measured 0.008); and closer to JAX's bf16 than
  the port's own fp32 maps are, by 4x at least on the heads' maps and 2x
  on the segm logits (measured 2.1x), so the port rounds where JAX does. The segm head's bilinear x2 is ``F.interpolate``, whose
  weights are exact fp32, where JAX rounds its interpolation matrices to
  bf16 (``acr_tpu/models/layers.py:271-272``): on unit-normal inputs the
  port's upsample is 0.0076 from the exact one at most, JAX's 0.019, and
  the two 0.2 % apart on average. That is the segm maps' difference;
- the pipeline: tests/test_torch_port_bf16_pipeline.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acr_tpu.io.params import flatten_params, unflatten_params
from acr_tpu.models import layers as jl
from acr_tpu.models.acr import ACRNet as JaxACRNet
from acr_tpu_torch.io.params import from_flax, init_params
from acr_tpu_torch.models import layers as tl
from acr_tpu_torch.models.acr import ACRNet
from acr_tpu_torch.pipeline.infer import cast_params
from test_torch_port_app import visible_hands
from test_torch_port_quant import to_flax

torch.set_num_threads(2)
BF16_EPS = 2.0 ** -7


@pytest.fixture(scope="module")
def flat():
    return visible_hands(to_flax(init_params(torch.Generator().manual_seed(0))))


def _mean_rel(want, got):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    return float(np.abs(want - got).mean() / (np.abs(want).mean() + 1e-30))


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("jax_mod,torch_mod,in_ch", [
    (jl.ConvBN(8, kernel=3, stride=2, use_bias=True, dtype=jnp.bfloat16),
     tl.ConvBN(5, 8, kernel=3, stride=2, use_bias=True), 5),
    (jl.BasicBlock(8, stride=2, downsample=True, dtype=jnp.bfloat16),
     tl.BasicBlock(5, 8, stride=2, downsample=True), 5),
    (jl.Bottleneck(4, downsample=True, dtype=jnp.bfloat16),
     tl.Bottleneck(5, 4, downsample=True), 5),
])
def test_blocks_bf16(jax_mod, torch_mod, in_ch):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 10, in_ch).astype(np.float32)
    params = jax_mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = _f32(jax_mod.apply(params, jnp.asarray(x, jnp.bfloat16)))
    torch_mod.load_state_dict(from_flax(flatten_params(params), net=torch_mod))
    cast_params(torch_mod.eval().requires_grad_(False), torch.bfloat16)
    got = torch_mod(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_EPS * np.abs(want).max())


def test_acrnet_bf16_maps_match_jax(flat):
    image = (np.random.RandomState(7).rand(1, 64, 64, 3) * 255).astype(np.uint8)
    want = jax.jit(JaxACRNet(dtype=jnp.bfloat16).apply)(
        unflatten_params(flat), image)
    net32 = ACRNet()
    net32.load_state_dict(from_flax(flat))
    net16 = ACRNet(dtype=torch.bfloat16)
    net16.load_state_dict(from_flax(flat))
    cast_params(net16, torch.bfloat16)
    with torch.no_grad():
        got = net16.eval()(torch.from_numpy(image))
        got32 = net32.eval()(torch.from_numpy(image))
    assert set(got) == set(want)
    for key in want:
        assert want[key].dtype == jnp.bfloat16
        assert got[key].dtype == torch.bfloat16, key
        w, g = _f32(want[key]), got[key].float().numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), key
        err, err32 = _mean_rel(w, g), _mean_rel(w, got32[key].numpy())
        assert err < (0.03 if key == "segms" else 2e-3), (key, err)
        assert err < err32 / (2 if key == "segms" else 4), (key, err, err32)
