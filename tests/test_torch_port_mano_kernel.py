"""The port's fused MANO path (B4) against the JAX package and the pure path.

The committed synthetic MANO assets, poses and betas from a numpy seed.
On the CPU ``fused_blend_skin`` runs its plain version; JAX's
``mano_forward_fused`` runs its Pallas kernel in interpret mode. The
kernel constants must equal JAX's ``build_kernel_data`` on the 778 real
vertex columns, bit for bit (``j_basis`` too: both sum it with numpy in
float32, ROADMAP C6), and every output 1e-5, the tolerance of
tests/test_mano_kernel.py:58.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acr_tpu.models import mano as jm
from acr_tpu.ops import mano_kernel as jk
from acr_tpu_torch.config import Config
from acr_tpu_torch.models import mano as tm
from acr_tpu_torch.ops import mano_kernel as tk
from acr_tpu_torch.pipeline import infer

torch.set_num_threads(2)
MANO_DIR = os.path.join(os.path.dirname(__file__), "..", "model_data", "mano")
SIDES = ("left", "right")


@pytest.fixture(scope="module")
def models():
    out = {}
    for side in SIDES:
        jmodel, _ = jm.load_mano_model(MANO_DIR, side)
        tmodel, _ = tm.load_mano_model(MANO_DIR, side, device="cpu")
        out[side] = (jmodel, jk.build_kernel_data(jmodel), tmodel,
                     tk.build_kernel_data(tmodel))
    return out


def _inputs(batch, seed):
    rng = np.random.RandomState(seed)
    poses = (rng.randn(batch, 48) * 0.5).astype(np.float32)
    betas = (rng.randn(batch, 10) * 0.7).astype(np.float32)
    return poses, betas


@pytest.mark.parametrize("side", SIDES)
def test_kernel_data_matches_jax(models, side):
    _, jdata, _, tdata = models[side]
    basis = np.asarray(jdata.basis).reshape(tk.N_COEF, 3, 896)
    np.testing.assert_array_equal(tdata.basis.numpy(), basis[:, :, :778])
    np.testing.assert_array_equal(tdata.weights_t.numpy(),
                                  np.asarray(jdata.weights_t)[:, :778])
    # built on the host by numpy in float32, as JAX builds it (ROADMAP C6)
    np.testing.assert_array_equal(tdata.j_basis.numpy(),
                                  np.asarray(jdata.j_basis))
    np.testing.assert_array_equal(tdata.hands_mean.numpy(),
                                  np.asarray(jdata.hands_mean))
    np.testing.assert_array_equal(tdata.tips.numpy(), np.asarray(jdata.tips))
    assert tdata.basis.shape == (146, 3, 778) and tdata.basis.is_contiguous()


@pytest.mark.parametrize("center_idx", [9, None])
@pytest.mark.parametrize("batch", [1, 2, 5, 65])
def test_fused_matches_jax_interpret(models, batch, center_idx):
    for k, side in enumerate(SIDES):
        _, jdata, _, tdata = models[side]
        poses, betas = _inputs(batch, seed=batch + k)
        want = jk.mano_forward_fused(jdata, jnp.asarray(poses),
                                     jnp.asarray(betas),
                                     center_idx=center_idx, interpret=True)
        got = tk.mano_forward_fused(tdata, torch.from_numpy(poses),
                                    torch.from_numpy(betas),
                                    center_idx=center_idx)
        for w, g in zip(want, got):
            if w is None:
                assert g is None
                continue
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("center_idx", [9, None])
@pytest.mark.parametrize("batch", [1, 8, 65])
def test_fused_matches_pure(models, batch, center_idx):
    for k, side in enumerate(SIDES):
        _, _, tmodel, tdata = models[side]
        poses, betas = (torch.from_numpy(a) for a in _inputs(batch, 10 + k))
        want = tm.mano_forward(tmodel, poses, betas, center_idx=center_idx)
        got = tk.mano_forward_fused(tdata, poses, betas, center_idx=center_idx)
        for w, g in zip(want, got):
            if w is None:
                assert g is None
                continue
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


def test_apply_mano_dispatch(models, monkeypatch):
    """``ManoAuto`` takes the fused path from PALLAS_MANO_MIN_BATCH hands
    and the pure path below it; ``ManoKernelData`` always the fused one,
    a ``ManoModel`` always the pure one."""
    calls = []
    real_fused, real_pure = infer.mano_forward_fused, infer.mano_forward

    def fused(*a, **kw):
        calls.append("fused")
        return real_fused(*a, **kw)

    def pure(*a, **kw):
        calls.append("pure")
        return real_pure(*a, **kw)

    monkeypatch.setattr(infer, "mano_forward_fused", fused)
    monkeypatch.setattr(infer, "mano_forward", pure)
    monkeypatch.setattr(infer, "PALLAS_MANO_MIN_BATCH", 6)
    _, _, tmodel, tdata = models["right"]
    auto = infer.ManoAuto(tmodel, tdata)
    for mano, batch, want in ((auto, 5, "pure"), (auto, 6, "fused"),
                              (auto, 7, "fused"), (tdata, 1, "fused"),
                              (tmodel, 64, "pure")):
        poses, betas = (torch.from_numpy(a) for a in _inputs(batch, batch))
        calls.clear()
        verts, joints, _ = infer.apply_mano(mano, poses, betas, 9)
        assert calls == [want], (type(mano).__name__, batch)
        ref = real_pure(tmodel, poses, betas, center_idx=9)
        np.testing.assert_allclose(verts.numpy(), ref[0].numpy(), atol=1e-5)
        np.testing.assert_allclose(joints.numpy(), ref[1].numpy(), atol=1e-5)


@pytest.mark.parametrize("mode,kind", [("off", tm.ManoModel),
                                       ("on", tk.ManoKernelData),
                                       ("auto", infer.ManoAuto)])
def test_pipeline_builds_mano_by_option(mode, kind, monkeypatch):
    monkeypatch.setattr(infer, "ACRNet", lambda **kw: torch.nn.Module())
    monkeypatch.setattr(torch.nn.Module, "load_state_dict",
                        lambda self, *a, **kw: None)
    cfg = Config(mano_model_path=MANO_DIR, configs_yml="",
                 use_pallas_mano=mode)
    pipe = infer.ACRPipeline(cfg, params={}, device="cpu")
    assert type(pipe.mano_l) is kind and type(pipe.mano_r) is kind


def test_cpu_tensors_launch_nothing(models):
    tk.reset_launch_counts()
    _, _, _, tdata = models["left"]
    poses, betas = (torch.from_numpy(a) for a in _inputs(4, 0))
    tk.mano_forward_fused(tdata, poses, betas)
    assert tk.LAUNCHES == {"mano_fused": 0}


def test_fused_blend_skin_checks_its_operands(models):
    _, _, _, tdata = models["left"]
    coef = torch.zeros(3, tk.N_COEF)
    g_rows = torch.zeros(36, 16)
    assert tk.fused_blend_skin(tdata, coef, g_rows).shape == (3, 778, 3)
    for bad_coef, bad_rows in ((coef.double(), g_rows),
                               (coef, g_rows[:35]),
                               (torch.zeros(tk.N_COEF, 3).T, g_rows)):
        with pytest.raises(ValueError):
            tk.fused_blend_skin(tdata, bad_coef, bad_rows)


def test_launch_shape_covers_every_hand_once():
    """Every hand and vertex falls in exactly one block, and the grid and
    block limits hold: 8 hands and 32 vertices per block of 256 threads."""
    for batch in (*range(1, 301), 1024, 4096, tk.MAX_BATCH):
        shape = tk.launch_shape(batch)
        gx, gy = shape.grid
        assert 1 <= gy <= tk.MAX_GRID_Y and 1 <= gx < 2 ** 31
        assert shape.threads % 32 == 0 and shape.threads <= 1024
        for n, per, blocks in ((batch, shape.hands, gy),
                               (tk.N_VERTS, shape.verts, gx)):
            covered = np.zeros(n, np.int64)
            for k in range(blocks):
                covered[k * per:(k + 1) * per] += 1
            assert (covered == 1).all() and blocks * per - n < per
    assert tk.launch_shape(8).grid == (25, 1)
    assert tk.launch_shape(1024).grid == (25, 128)
    for bad in (0, tk.MAX_BATCH + 1):
        with pytest.raises(ValueError):
            tk.launch_shape(bad)


def test_wrong_constants_still_raise(models):
    """The constants are checked on every call: a ManoKernelData with a
    wrong one raises, also after good data has passed."""
    _, _, _, tdata = models["left"]
    coef, g_rows = torch.zeros(2, tk.N_COEF), torch.zeros(24, 16)
    assert tk.fused_blend_skin(tdata, coef, g_rows).shape == (2, 778, 3)
    for bad in (tdata._replace(basis=tdata.basis[:, :, :777].contiguous()),
                tdata._replace(basis=tdata.basis.transpose(1, 2)),
                tdata._replace(weights_t=tdata.weights_t[:15]),
                tdata._replace(weights_t=tdata.weights_t.double())):
        for _ in range(2):
            with pytest.raises(ValueError):
                tk.fused_blend_skin(bad, coef, g_rows)
    assert tk.fused_blend_skin(tdata, coef, g_rows).shape == (2, 778, 3)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(models):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    _, _, tmodel, _ = models["right"]
    data = tk.build_kernel_data(tm.ManoModel(*(t.to(dev) for t in tmodel)))
    rng = np.random.RandomState(0)
    # partial and whole blocks of 8 hands, from one block to 128
    for batch in (1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 1024):
        coef = torch.from_numpy(rng.randn(batch, tk.N_COEF).astype(
            np.float32) * 0.1).to(dev)
        g_rows = torch.from_numpy(rng.randn(batch * 12, 16).astype(
            np.float32) * 0.1).to(dev)
        before = tk.LAUNCHES["mano_fused"]
        got = tk.fused_blend_skin(data, coef, g_rows)
        want = tk.fused_blend_skin_plain(data, coef, g_rows)
        torch.cuda.synchronize()
        assert tk.LAUNCHES["mano_fused"] == before + 1
        assert float((got - want).abs().max()) <= 1e-5
