"""The port's quantized ACRNet in each of the four modes against JAX's
canonical ``ACRNet(quantize=mode)`` on JAX's own quantized tree.

The float weights are ``init_params`` (seed 0), carried to flax; the
activation stats are the port's calibration on one 64 px frame from a
numpy seed (held against JAX's observe run in
tests/test_torch_port_quant.py); JAX's ``quantize_tree_int8`` quantizes,
and ``from_flax`` carries its int8 tree across. JAX is built canonical,
without the s2d rewrites and merged heads, as tests/test_quant.py's bare
``ACRNet()``. JAX applies op by op, without jit: each primitive compiles
once and the four modes share them (about 30 s for the four, five times
less than four jitted programs). Tolerance: every output map within 1e-3
mean relative error of JAX's, 50 times inside tests/test_quant.py's int8-vs-float bound
of 0.05 (measured below 1e-6: the int32 products are exact, and only the
last bits of the float activations between them differ).
"""

import numpy as np
import pytest
import torch

from acr_tpu.io.params import flatten_params, unflatten_params
from acr_tpu.models.acr import ACRNet as JaxACRNet
from acr_tpu.ops import quant as jq
from acr_tpu_torch.io.params import from_flax, init_params
from acr_tpu_torch.models.acr import ACRNet
from acr_tpu_torch.ops import quant as tq
from test_torch_port_quant import MODES, jax_stats, quant_names, to_flax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    state_dict = init_params(torch.Generator().manual_seed(0))
    image = (np.random.RandomState(7).rand(1, 64, 64, 3) * 255).astype(np.uint8)
    net = ACRNet()
    net.load_state_dict(state_dict)
    net.eval()
    with torch.no_grad():
        float_maps = net(torch.from_numpy(image))
    return state_dict, image, net, float_maps


def _mean_rel(want, got):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    return float(np.abs(want - got).mean() / (np.abs(want).mean() + 1e-30))


@pytest.mark.parametrize("mode", MODES)
def test_acrnet_quantized_matches_jax(setup, mode):
    state_dict, image, float_net, float_maps = setup
    stats = tq.calibrate_amax(float_net, [image], mode)
    per_channel, bits = mode.endswith("_pc"), 4 if mode == "int4w" else 8
    jtree = jq.quantize_tree_int8(unflatten_params(to_flax(state_dict)),
                                  jax_stats(stats), per_channel=per_channel,
                                  weight_bits=bits)
    want = JaxACRNet(quantize=mode).apply(jtree, image)

    net = ACRNet(quantize=mode)
    net.load_state_dict(from_flax(flatten_params(jtree), net=net))
    net.eval()
    assert len(quant_names(net)) == (348 if mode == "int8_r" else 338)
    # the port's own quantization of the same stats is JAX's tree
    own = tq.quantize_tree_int8(state_dict, stats, per_channel=per_channel,
                                weight_bits=bits)
    loaded = net.state_dict()
    assert all(torch.equal(v, loaded[k]) for k, v in own.items())
    with torch.no_grad():
        got = net(torch.from_numpy(image))
    assert set(got) == set(want)
    for key in want:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        assert np.isfinite(g).all(), key
        assert _mean_rel(w, g) < 1e-3, (key, _mean_rel(w, g))
        # and the quantization does something: the float maps differ
        assert _mean_rel(float_maps[key].numpy(), g) > 0, key
