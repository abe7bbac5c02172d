"""The port's bridge to the host C++ library (``acr_tpu_torch.io.native``)
and the app's host paths (``renderer='native'``, ``jit_translation_solve
=False``) against the JAX package.

Both bridges call the same source (``native/acr_native.cpp``) compiled
by the same compiler with the same flags, the JAX one through
``native/Makefile``, the port's into ``build/native/``: on the same
inputs their results are equal bit for bit. The apps run the flax weights
of ``tests/test_torch_port_app.py`` (both hands plausible and inside the
frame) at 128 px input and render, both hands forced detected: the
reference-format results agree to float16 resolution (as
``tests/test_torch_port_stream.py``), the host-rendered frames on all but
edge pixels (the meshes differ by float rounding): under 1 % of the
pixels differ by more than 8 grey levels.
"""

import os

import numpy as np
import pytest
import torch

from acr_tpu.config import Config as JaxConfig
from acr_tpu.io import native as jnative
from acr_tpu.io.params import unflatten_params
from acr_tpu.pipeline.app import ACRApp as JaxACRApp
from acr_tpu.viz.visualizer import Visualizer as JaxVisualizer
from acr_tpu_torch.config import Config
from acr_tpu_torch.io import native
from acr_tpu_torch.io.params import from_flax
from acr_tpu_torch.pipeline.app import ACRApp
from acr_tpu_torch.viz.visualizer import Visualizer
from test_torch_port_app import MANO_DIR, flat  # noqa: F401 (fixture)
from test_torch_port_stream import assert_same_results

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _projected(rng, t, n=21, focal=1265.0, c=256.0):
    j3d = rng.randn(n, 3).astype(np.float32) * 0.08
    p = j3d + t
    uv = np.stack([focal * p[:, 0] / p[:, 2] + c,
                   focal * p[:, 1] / p[:, 2] + c], 1).astype(np.float32)
    return j3d, uv


def test_bridge_builds_under_build():
    path = native.build_library()
    assert path.startswith(os.path.join(REPO, "build", "native") + os.sep)
    assert os.path.basename(path) == "libacr_native.so"
    assert native.library() is native.library()
    assert native.build_library() == path          # keyed, built once
    # never the JAX package's build
    assert not os.path.samefile(os.path.dirname(path),
                                os.path.join(REPO, "native"))


@pytest.mark.parametrize("ransac", [False, True])
def test_estimate_translation_matches_jax(ransac):
    assert jnative.available()
    rng = np.random.RandomState(1)
    for t in ([0.1, -0.2, 2.5], [0.05, 0.1, 2.0], [-0.3, 0.0, 0.6]):
        j3d, uv = _projected(rng, np.array(t, np.float32))
        uv_bad = uv.copy()
        uv_bad[:3] += 300.0                    # gross outliers
        for points in (uv, uv_bad):
            got = native.estimate_translation(j3d, points, ransac=ransac)
            want = jnative.estimate_translation(j3d, points, ransac=ransac)
            assert got.dtype == np.float32 and got.shape == (3,)
            np.testing.assert_array_equal(got, want)
        # RANSAC's defaults (100 iterations, 20 px, seed 0) recover t
        if ransac:
            np.testing.assert_allclose(
                native.estimate_translation(j3d, uv_bad), t, atol=5e-2)
    with pytest.raises(ValueError, match="singular"):
        native.estimate_translation(np.zeros((4, 3)), np.zeros((4, 2)),
                                    ransac=False)
    with pytest.raises(ValueError, match="shape"):
        native.estimate_translation(np.zeros((4, 2)), np.zeros((4, 2)))


def test_rasterize_matches_jax():
    from scipy.spatial import ConvexHull
    rng = np.random.RandomState(2)
    pts = rng.randn(200, 3).astype(np.float32) * 0.05
    faces = ConvexHull(pts).simplices.astype(np.int32)
    verts = pts + np.array([0, 0, 1.0], np.float32)
    colors = rng.rand(len(faces), 3).astype(np.float32)
    got = native.rasterize(verts, faces, colors, size=128, focal=200.0)
    want = jnative.rasterize(verts, faces, colors, size=128, focal=200.0)
    assert got.shape == (128, 128, 4) and got[..., 3].any()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="outside"):
        native.rasterize(verts, faces + len(verts), colors, size=16)


def _hands_out(rng, det):
    out = {"verts": rng.randn(1, 2, 778, 3).astype(np.float32) * 0.03,
           "cam_trans": np.array([[[-0.1, 0.0, 1.2], [0.1, 0.0, 1.2]]],
                                 np.float32),
           "detection_flag": np.array([det])}
    return out


@pytest.mark.parametrize("det", [(True, True), (False, True), (False, False)])
def test_visualizer_native_matches_jax(det):
    cfg = dict(renderer="native", render_size=96, mano_model_path=MANO_DIR,
               configs_yml="")
    faces = np.stack([np.load(os.path.join(MANO_DIR, f"mano_{s}.npz"))["faces"]
                      for s in ("left", "right")]).astype(np.int32)
    out = _hands_out(np.random.RandomState(3), det)
    got = Visualizer(Config(**cfg), faces, device="cpu").render_rgba(out)
    want = JaxVisualizer(JaxConfig(**cfg), faces).render_rgba(out)
    assert got.shape == (96, 96, 4) and got[..., 3].any() == any(det)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_native_renderer_is_intrinsics_only():
    faces = np.zeros((2, 1538, 3), np.int32)
    for cam in ("fov", "ortho", "pt3d"):
        with pytest.raises(ValueError, match="intrinsics camera only"):
            Visualizer(Config(renderer="native", camera_model=cam,
                              configs_yml=""), faces, device="cpu")
    Visualizer(Config(renderer="native", configs_yml=""), faces, device="cpu")


@pytest.mark.parametrize("override", [dict(renderer="native"),
                                      dict(jit_translation_solve=False)])
def test_missing_library_raises(flat, tmp_path, monkeypatch, override):
    """Where JAX warns and keeps the device solve, the port raises when a
    host path was asked for and the library cannot be built."""
    monkeypatch.setattr(native, "SOURCE", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        ACRApp(Config(mano_model_path=MANO_DIR, configs_yml="", **override),
               params=from_flax(flat), device="cpu")
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.estimate_translation(np.zeros((4, 3)), np.zeros((4, 2)))


def _kw(tmp_path, name, **over):
    kw = dict(input_size=128, render_size=128, mano_model_path=MANO_DIR,
              configs_yml="", renderer="native", jit_translation_solve=False,
              centermap_conf_thresh=-1e9, save_dict_results=True,
              output_dir=str(tmp_path / name) + "/")
    kw.update(over)
    return kw


def _same_frames(got_dir, want_dir):
    import cv2
    names = sorted(n for n in os.listdir(want_dir) if n.endswith(".jpg"))
    assert names and names == sorted(
        n for n in os.listdir(got_dir) if n.endswith(".jpg"))
    for n in names:
        a = cv2.imread(os.path.join(got_dir, n)).astype(np.int16)
        b = cv2.imread(os.path.join(want_dir, n)).astype(np.int16)
        assert a.shape == b.shape
        assert (np.abs(a - b) > 8).mean() < 0.01, n


def test_image_mode_host_paths_match_jax(flat, tmp_path):
    """Image mode with the native renderer and the host solve, against
    JAX's app on the same frame."""
    import cv2
    rng = np.random.RandomState(5)
    img = tmp_path / "frame.jpg"
    cv2.imwrite(str(img), (rng.rand(96, 128, 3) * 255).astype(np.uint8))
    kw = dict(demo_mode="image", inputs=str(img))
    japp = JaxACRApp(JaxConfig(**_kw(tmp_path, "jax", **kw)),
                     params=unflatten_params(flat))
    want = japp.run()
    app = ACRApp(Config(**_kw(tmp_path, "port", **kw)),
                 params=from_flax(flat), device="cpu")
    got = app.run()
    assert_same_results(got, want)
    assert "_rgba" not in app.last_output        # drawn on the host
    _same_frames(app.output_dir, japp.output_dir)
    # the host solve replaced the device's LS translation
    out = app.last_output
    pj = (out["pj2d"][0, 1] + 1.0) * 64.0
    np.testing.assert_array_equal(
        out["cam_trans"][0, 1],
        native.estimate_translation(out["j3d"][0, 1], pj, focal=1265.0,
                                    cx=64.0, cy=64.0))


@pytest.mark.parametrize("override", [
    dict(),                                          # both host paths
    dict(renderer="tpu"),                            # the host solve alone
])
def test_folder_b4_host_paths_match_jax(flat, tmp_path, override, caplog):
    """Folder mode at val_batch_size 4 (5 frames: two chunks, the last
    padded) on the per-stage route: the chunk step without its render,
    one readback, the host solve, then each frame drawn."""
    import cv2
    import logging
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    rng = np.random.RandomState(6)
    for i in range(5):
        cv2.imwrite(str(frames_dir / f"{i:06d}.jpg"),
                    (rng.rand(96, 128, 3) * 255).astype(np.uint8))
    kw = dict(demo_mode="folder", inputs=str(frames_dir), val_batch_size=4,
              **override)
    japp = JaxACRApp(JaxConfig(**_kw(tmp_path, "jax", **kw)),
                     params=unflatten_params(flat))
    want = japp.run()
    app = ACRApp(Config(**_kw(tmp_path, "port", **kw)),
                 params=from_flax(flat), device="cpu")
    with caplog.at_level(logging.INFO, logger="acr_tpu_torch"):
        got = app.run()
    assert len(got) == 5
    assert_same_results(got, want)
    assert "_rgba" not in app.last_output
    why = "host translation solve"
    assert f"fused chunk step bypassed ({why})" in caplog.text
    _same_frames(app.output_dir, japp.output_dir)
