"""acr_tpu_torch MANO and projection against acr_tpu.

MANO: the committed npz assets, random poses/betas from a numpy seed,
2e-5 (the tolerance of tests/test_mano.py:52). Projection: 1e-5.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acr_tpu.models import mano as jm
from acr_tpu.pipeline import project as jproj
from acr_tpu_torch.models import mano as tm
from acr_tpu_torch.pipeline import project as tproj

torch.set_num_threads(2)
MANO_DIR = os.path.join(os.path.dirname(__file__), "..", "model_data", "mano")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("side,center_idx", [("left", 9), ("right", 9),
                                              ("right", None)])
def test_mano_forward(side, center_idx):
    jmodel, jfaces = jm.load_mano_model(MANO_DIR, side)
    tmodel, tfaces = tm.load_mano_model(MANO_DIR, side, device="cpu")
    np.testing.assert_array_equal(tfaces, jfaces)
    rng = np.random.RandomState(0)
    poses = (rng.randn(4, 48) * 0.4).astype(np.float32)
    poses[0] = 0.0
    betas = rng.randn(4, 10).astype(np.float32)
    want = jm.mano_forward(jmodel, jnp.asarray(poses), jnp.asarray(betas),
                           center_idx=center_idx)
    got = tm.mano_forward(tmodel, t(poses), t(betas), center_idx=center_idx)
    for w, g in zip(want, got):
        if w is None:
            assert g is None
            continue
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def test_projection():
    rng = np.random.RandomState(1)
    pts = rng.randn(3, 2, 21, 3).astype(np.float32) * 0.1
    cam = np.concatenate([rng.rand(3, 2, 1) + 0.5, rng.randn(3, 2, 2) * 0.2],
                         -1).astype(np.float32)
    for keep in (False, True):
        np.testing.assert_allclose(
            tproj.weak_persp_project(t(pts), t(cam), keep_dim=keep).numpy(),
            np.asarray(jproj.weak_persp_project(jnp.asarray(pts),
                                                jnp.asarray(cam), keep_dim=keep)),
            atol=1e-5)
    kp = rng.rand(3, 21, 2).astype(np.float32) * 2 - 1
    off = np.array([[300, 400, 0, 0, 0, 0, 50, 0, 50, 0],
                    [512, 512, 0, 0, 0, 0, 0, 0, 0, 0],
                    [200, 100, 3, 1, 2, 4, 0, 25, 0, 25]], np.float32)
    np.testing.assert_allclose(
        tproj.kp2d_to_org_image(t(kp), t(off[:, None, :])).numpy(),
        np.asarray(jproj.kp2d_to_org_image(jnp.asarray(kp),
                                           jnp.asarray(off[:, None, :]))),
        atol=1e-5)


def test_translation_solve():
    rng = np.random.RandomState(2)
    j3d = rng.randn(4, 2, 21, 3).astype(np.float32) * 0.05
    trans = np.stack([rng.randn(4, 2) * 0.1, rng.randn(4, 2) * 0.1,
                      rng.rand(4, 2) + 0.5], -1).astype(np.float32)
    cam3 = j3d + trans[:, :, None, :]
    uv = 1265.0 * cam3[..., :2] / cam3[..., 2:] + 256.0
    want = np.asarray(jproj.estimate_translation_ls(jnp.asarray(j3d),
                                                    jnp.asarray(uv)))
    got = tproj.estimate_translation_ls(t(j3d), t(uv)).numpy()
    assert got.shape == (4, 2, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, trans, atol=1e-3)
