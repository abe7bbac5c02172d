"""acr_tpu_torch.io.params: flax trees -> state dicts, and the seeded init.

Every leaf of the full ``ACRNet().init`` tree must land in the port's
canonical network exactly once, with the layout the port expects.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acr_tpu.io.params import flatten_params
from acr_tpu.models.acr import ACRNet as JaxACRNet
from acr_tpu_torch.io.params import from_flax, init_params, load_params, split_parser
from acr_tpu_torch.models.acr import ACRNet

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def flat():
    params = JaxACRNet().init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 32, 3), jnp.uint8))
    return flatten_params(params)


def _torch_key(path):
    parts = path.split("/")
    leaf = "weight" if parts[-1] == "kernel" else parts[-1]
    return ".".join(parts[:-1] + [leaf])


def test_every_leaf_used_once_with_right_layout(flat):
    sd = from_flax(flat)
    ref = ACRNet().state_dict()
    assert len(sd) == len(flat) == len(ref)
    assert set(sd) == set(ref)
    for path, value in flat.items():
        got = sd[_torch_key(path)].numpy()
        if path.endswith("kernel") and value.ndim == 4:
            want = value.transpose(3, 2, 0, 1)           # HWIO -> OIHW
        elif path.endswith("kernel"):
            want = value.T                               # Dense (in,out)
        else:
            want = value                                 # BN, bias, LC w
        np.testing.assert_array_equal(got, want, err_msg=path)
        assert got.shape == tuple(ref[_torch_key(path)].shape), path
    # the locally-connected weights keep their (O, C, J) layout
    assert tuple(sd["l_pose_lc.w"].shape) == (6, 256, 16)
    assert tuple(sd["r_shape_fc.weight"].shape) == (10, 1024)


def test_unused_and_missing_keys_raise(flat):
    extra = dict(flat)
    extra["backbone/not_a_layer/kernel"] = np.zeros((1, 1, 1, 1), np.float32)
    with pytest.raises(KeyError, match="unused"):
        from_flax(extra)
    short = dict(flat)
    short.pop("segm/out_conv2/bias")
    with pytest.raises(KeyError, match="missing"):
        from_flax(short)
    bad = dict(flat)
    bad["segm/out_conv2/bias"] = np.zeros((34,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_flax(bad)


def test_npz_and_merge_head_round_trip(flat, tmp_path):
    rng = np.random.RandomState(0)
    tree = dict(flat)
    tree["parser/fusion_fc/kernel"] = rng.randn(424, 212).astype(np.float32)
    tree["parser/fusion_fc/bias"] = rng.randn(212).astype(np.float32)
    path = tmp_path / "ckpt.npz"
    np.savez(path, **tree)
    sd, fusion = load_params(str(path))
    assert set(sd) == set(ACRNet().state_dict())
    np.testing.assert_array_equal(fusion["weight"].numpy(),
                                  tree["parser/fusion_fc/kernel"].T)
    np.testing.assert_array_equal(fusion["bias"].numpy(),
                                  tree["parser/fusion_fc/bias"])
    net_flat, none = split_parser(flat)
    assert none is None and net_flat.keys() == flat.keys()


def test_init_params_matches_flax_tree_and_recipe(flat):
    sd = init_params(torch.Generator().manual_seed(0))
    ref = from_flax(flat)
    assert sd.keys() == ref.keys()
    for key in sd:
        assert sd[key].shape == ref[key].shape, key
    assert all(torch.equal(sd[k], torch.full_like(sd[k], 0.2))
               for k in sd if k.endswith(".scale"))
    assert all(not sd[k].any() for k in sd if k.endswith(".bias"))
    # lecun normal: std sqrt(1/fan_in), truncated at 2 sigma
    w = sd["contact_conv.conv.weight"]
    fan_in = w[0].numel()
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.05
    assert w.abs().max().item() <= 2.0 / 0.8796256610342398 / np.sqrt(fan_in)
    again = init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    ACRNet().load_state_dict(sd, strict=True)
