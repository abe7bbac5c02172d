"""acr_tpu_torch rotations, center decode and parse_outputs against acr_tpu.

Inputs from a numpy seed go through both. The parser cases include a
frame with both hands detected (cross prior on and off by the gate), an
all-undetected frame (the idx-0 fallback) and the merge mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acr_tpu.ops import rotations as jr
from acr_tpu.parser import center as jc
from acr_tpu.parser import parse as jp
from acr_tpu_torch.ops import rotations as tr
from acr_tpu_torch.parser import center as tc
from acr_tpu_torch.parser import parse as tp

torch.set_num_threads(2)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("fn", ["axis_angle_to_quat", "quat_to_rotmat",
                                "axis_angle_to_rotmat", "rot6d_to_rotmat",
                                "rotmat_to_quat", "quat_to_axis_angle",
                                "rotmat_to_axis_angle", "rot6d_to_axis_angle"])
def test_rotations(fn):
    rng = np.random.RandomState(0)
    shapes = {"axis_angle_to_quat": (5, 7, 3), "quat_to_rotmat": (5, 7, 4),
              "axis_angle_to_rotmat": (5, 7, 3), "rot6d_to_rotmat": (5, 7, 6),
              "quat_to_axis_angle": (5, 7, 4), "rot6d_to_axis_angle": (5, 96)}
    if fn in ("rotmat_to_quat", "rotmat_to_axis_angle"):
        x = np.asarray(jr.axis_angle_to_rotmat(
            jnp.asarray(rng.randn(40, 3).astype(np.float32) * 2)))
        # the small-angle and near-pi branches
        x = np.concatenate([x, np.eye(3, dtype=np.float32)[None],
                            np.diag([1, -1, -1]).astype(np.float32)[None]])
    else:
        x = rng.randn(*shapes[fn]).astype(np.float32)
        x[0, 0] = 0.0                      # zero-length inputs hit the guards
    want = np.asarray(getattr(jr, fn)(jnp.asarray(x)))
    got = getattr(tr, fn)(t(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_center_decode():
    rng = np.random.RandomState(1)
    cm = rng.randn(3, 16, 16, 1).astype(np.float32)
    cm[1] = -np.abs(cm[1])                 # no positive peak: ties at 0
    cm[2, 3:6, 3:6] = 2.0                  # a plateau: lowest index wins
    np.testing.assert_array_equal(
        tc.nms_heatmap(t(cm), 5).numpy(),
        np.asarray(jc.nms_heatmap(jnp.asarray(cm), 5)))
    for k, thresh in ((1, 0.35), (4, 0.0)):
        want = jc.decode_centers(jnp.asarray(cm), k, thresh, nms_kernel=5)
        got = tc.decode_centers(t(cm), k, thresh, nms_kernel=5)
        for name in want._fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)


def _maps(rng, peaks):
    """Random output maps; ``peaks`` {side: (row, col) or None} plants a
    center above threshold (None leaves every score below it)."""
    out = {}
    for side in ("l", "r"):
        c = rng.rand(2, 64, 64, 1).astype(np.float32) * 0.2
        if peaks[side] is not None:
            c[:, peaks[side][0], peaks[side][1], 0] = 0.9
        out[f"{side}_center_map"] = c
        out[f"{side}_params_maps"] = rng.randn(2, 64, 64, 109).astype(np.float32) * 0.5
        out[f"{side}_prior_maps"] = rng.randn(2, 64, 64, 106).astype(np.float32) * 0.1
    return out


@pytest.mark.parametrize("case", ["both_near", "both_far", "none", "left_only",
                                  "merge"])
def test_parse_outputs(case):
    rng = np.random.RandomState(2)
    peaks = {"both_near": {"l": (10, 12), "r": (20, 30)},
             "both_far": {"l": (2, 2), "r": (60, 61)},
             "none": {"l": None, "r": None},
             "left_only": {"l": (40, 5), "r": None},
             "merge": {"l": (10, 12), "r": (20, 30)}}[case]
    maps = _maps(rng, peaks)
    kw = dict(conf_thresh=0.35, prior_gate_px=32.0, centermap_size=64,
              nms_kernel=5, max_hand=4)
    want_merge = got_merge = None
    if case == "merge":
        w = rng.randn(424, 212).astype(np.float32) * 0.05
        b = rng.randn(212).astype(np.float32) * 0.05
        want_merge = {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}
        got_merge = {"weight": t(w.T), "bias": t(b)}
        kw["prior_mode"] = "merge"
    want = jp.parse_outputs({k: jnp.asarray(v) for k, v in maps.items()},
                            merge_params=want_merge, **kw)
    got = tp.parse_outputs({k: t(v) for k, v in maps.items()},
                           merge_params=got_merge, **kw)
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    flags = got.detection_flag.numpy()
    expect = {"none": [False, False], "left_only": [True, False]}.get(
        case, [True, True])
    assert (flags == np.array(expect)).all()
    if case == "none":                     # idx-0 fallback
        assert (got.flat_inds.numpy() == 0).all()


def test_sample_and_split():
    rng = np.random.RandomState(3)
    maps = rng.randn(3, 8, 8, 109).astype(np.float32)
    inds = np.array([0, 17, 63], np.int32)
    np.testing.assert_array_equal(
        tp.sample_at_index(t(maps), t(inds)).numpy(),
        np.asarray(jp.sample_at_index(jnp.asarray(maps), jnp.asarray(inds))))
    params = rng.randn(3, 2, 109).astype(np.float32)
    for rot_type, rot_dim in (("6D", 6), ("angular", 3)):
        n = 3 + rot_dim * 16 + 10
        want = jp.split_params(jnp.asarray(params[..., :n]), rot_type, rot_dim)
        got = tp.split_params(t(params[..., :n]), rot_type, rot_dim)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
