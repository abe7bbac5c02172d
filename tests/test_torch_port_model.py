"""acr_tpu_torch.models: layers, HRNet and ACRNet against the canonical JAX modules.

Inputs come from a numpy seed and go through both; weights are the
flax init carried over by ``from_flax`` (golden recipe: BN scale x 0.2,
which keeps a random network's activations finite). Tolerance 1e-4 abs
on every map unless a test states otherwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acr_tpu.io.params import flatten_params
from acr_tpu.models import layers as jl
from acr_tpu.models.acr import ACRNet as JaxACRNet
from acr_tpu.models.hrnet import HRNetBackbone as JaxHRNet
from acr_tpu.models.hrnet import SegmNet as JaxSegmNet
from acr_tpu_torch.io.params import from_flax
from acr_tpu_torch.models import layers as tl
from acr_tpu_torch.models.acr import ACRNet, hadamard_pool
from acr_tpu_torch.models.hrnet import HRNetBackbone, SegmNet

torch.set_num_threads(2)
ATOL = 1e-4


def _golden_scale(params):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x * 0.2 if getattr(p[-1], "key", None) == "scale" else x,
        params)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def tree():
    params = JaxACRNet().init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 32, 3), jnp.uint8))
    return _golden_scale(params)["params"]


@pytest.fixture(scope="module")
def image():
    rng = np.random.RandomState(7)
    return (rng.rand(1, 64, 64, 3) * 255).astype(np.uint8)


def _subtree_flat(tree, name):
    return flatten_params({"params": tree[name]})


@pytest.mark.parametrize("jax_mod,torch_mod,in_ch,stride", [
    (jl.ConvBN(8, kernel=3, stride=2, use_bias=True),
     tl.ConvBN(5, 8, kernel=3, stride=2, use_bias=True), 5, 2),
    (jl.ConvBN(8, kernel=1, relu=False), tl.ConvBN(5, 8, kernel=1, relu=False),
     5, 1),
    (jl.BasicBlock(8, stride=2, downsample=True),
     tl.BasicBlock(5, 8, stride=2, downsample=True), 5, 2),
    (jl.BasicBlock(5), tl.BasicBlock(5, 5), 5, 1),
    (jl.Bottleneck(4, downsample=True), tl.Bottleneck(5, 4, downsample=True),
     5, 1),
])
def test_blocks(jax_mod, torch_mod, in_ch, stride):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 10, in_ch).astype(np.float32)
    params = jax_mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    flat = flatten_params(params)
    rng_bn = np.random.RandomState(2)
    flat = {k: (v + rng_bn.rand(*v.shape).astype(np.float32)
                if k.endswith(("scale", "bias")) else v)
            for k, v in flat.items()}
    from acr_tpu.io.params import unflatten_params
    want = np.asarray(jax_mod.apply(unflatten_params(flat), jnp.asarray(x)))
    torch_mod.load_state_dict(from_flax(flat, net=torch_mod))
    got = nhwc(torch_mod(nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


def test_resampling_and_coords():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, 7, 3).astype(np.float32)
    np.testing.assert_allclose(
        nhwc(tl.resize_bilinear_align_corners(nchw(x), (12, 14))),
        np.asarray(jl.resize_bilinear_align_corners(jnp.asarray(x), (12, 14))),
        atol=1e-6)
    np.testing.assert_array_equal(
        nhwc(tl.upsample_nearest(nchw(x), 4)),
        np.asarray(jl.upsample_nearest(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(
        nhwc(tl.downsample_nearest_half(nchw(x))),
        np.asarray(jl.downsample_nearest_half(jnp.asarray(x))))
    np.testing.assert_array_equal(
        nhwc(tl.get_coord_maps(16)), np.asarray(jl.get_coord_maps(16)))


def test_hadamard_pool():
    from acr_tpu.models.acr import hadamard_pool as jax_pool
    rng = np.random.RandomState(4)
    f = rng.randn(2, 8, 8, 5).astype(np.float32)
    a = rng.randn(2, 8, 8, 3).astype(np.float32) * 3
    np.testing.assert_allclose(
        hadamard_pool(nchw(f), nchw(a)).numpy(),
        np.asarray(jax_pool(jnp.asarray(f), jnp.asarray(a))), atol=1e-6)


def test_backbone_and_segm(tree, image):
    flat = _subtree_flat(tree, "backbone")
    feats_j = JaxHRNet().apply({"params": tree["backbone"]}, jnp.asarray(image))
    net = HRNetBackbone()
    net.load_state_dict(from_flax(flat, net=net))
    with torch.no_grad():
        feats_t = net(torch.from_numpy(image))
    np.testing.assert_allclose(nhwc(feats_t), np.asarray(feats_j), atol=ATOL)

    segm_j = JaxSegmNet().apply({"params": tree["segm"]}, feats_j)
    segm = SegmNet()
    segm.load_state_dict(from_flax(_subtree_flat(tree, "segm"), net=segm))
    with torch.no_grad():
        segm_t = segm(nchw(np.asarray(feats_j)))
    assert segm_t.shape == (1, 33, 32, 32)
    np.testing.assert_allclose(nhwc(segm_t), np.asarray(segm_j), atol=ATOL)


def test_acrnet_output_maps(tree, image):
    check_acrnet(tree, image, "concat")


def check_acrnet(tree, image, offset_mode):
    jnet = JaxACRNet(offset_mode=offset_mode)
    want = jax.jit(jnet.apply)({"params": tree}, jnp.asarray(image))
    flat = flatten_params({"params": tree})
    if offset_mode != "concat":      # the fuse convs exist only in concat
        flat = {k: v for k, v in flat.items() if "_fuse_conv/" not in k}
    net = ACRNet(offset_mode=offset_mode)
    net.load_state_dict(from_flax(flat, net=net))
    with torch.no_grad():
        got = net(torch.from_numpy(image))
    assert set(got) == set(want)
    for key in want:
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape, key
        assert np.isfinite(g).all(), key
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=key)
    assert got["l_params_maps"].shape == (1, 8, 8, 109)
    assert got["segms"].shape == (1, 32, 32, 33)
