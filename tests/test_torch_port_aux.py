"""The port's auxiliary views (``show_items``) against the JAX package's,
and the folder path at ``val_batch_size`` 2 in bf16 and int8 against the
port's per-frame path.

The views are host copies: on the same host outputs (from a numpy seed)
every view equals JAX's pixel for pixel, and the copied functions'
sources equal the originals. Through the apps (image mode, 128 px, the
weights of tests/test_torch_port_bf16.py, both hands forced detected),
the port writes the files JAX writes, under ``_aux_path``'s names; their
pixels differ only where the two outputs' last bits move a drawn line or
a heat-map level (mean absolute difference below one grey level).
Folder mode at b2 against b1: the same results to 2e-3, as
tests/test_torch_port_batched.py's b2 against b1 (measured at most 1.5e-5
relative, in fp32+int8), and the same files written. The CLI runs video
mode with -t in bf16+int8 at b2 with the views, and webcam mode's
StreamingLoop runs with -t in bf16 and bf16+int8_pc.
"""

import inspect
import os

import numpy as np
import pytest
import torch

from acr_tpu.config import Config as JaxConfig
from acr_tpu.io.params import unflatten_params
from acr_tpu.pipeline.app import ACRApp as JaxACRApp
from acr_tpu.viz import skeleton3d as jsk
from acr_tpu.viz import visualizer as jvis
from acr_tpu_torch.config import Config
from acr_tpu_torch.io.params import from_flax, init_params
from acr_tpu_torch.pipeline.app import ACRApp
from acr_tpu_torch.pipeline.preprocess import img_preprocess
from acr_tpu_torch.viz import skeleton3d as tsk
from acr_tpu_torch.viz import visualizer as tvis
from test_torch_port_app import visible_hands
from test_torch_port_quant import to_flax

torch.set_num_threads(2)
MANO_DIR = os.path.join(os.path.dirname(__file__), "..", "model_data", "mano")
AUX = ("org_img", "pj2d", "centermap", "j3d")
SHOW = ("mesh",) + AUX


@pytest.fixture(scope="module")
def flat():
    return visible_hands(to_flax(init_params(torch.Generator().manual_seed(0))))


def test_copies_equal_source():
    for name in ("hand_skeleton", "_joint_color", "MANO2INTERHAND",
                 "_FINGER_RGB", "_FINGERS"):
        j, t = getattr(jvis, name), getattr(tvis, name)
        if callable(j):
            assert inspect.getsource(t) == inspect.getsource(j), name
        elif isinstance(j, np.ndarray):
            np.testing.assert_array_equal(t, j)
        else:
            assert t == j, name
    for name in ("draw_keypoints", "make_heatmap_overlay"):
        assert inspect.getsource(getattr(tvis.Visualizer, name)) == \
            inspect.getsource(getattr(jvis.Visualizer, name)), name
    for name in ("Plotter3dPoses", "_rotation", "BONES_21"):
        j, t = getattr(jsk, name), getattr(tsk, name)
        if callable(j):
            assert inspect.getsource(t) == inspect.getsource(j), name
        else:
            assert t == j, name


def _host_out(rng, det, size):
    """Host outputs with a batch of 1, as the app reads them back."""
    return {
        "detection_flag": np.array([det]),
        "pj2d": (rng.rand(1, 2, 21, 2) * 1.6 - 0.8).astype(np.float32),
        "j3d": (rng.randn(1, 2, 21, 3) * 0.05).astype(np.float32),
        "l_center_map": rng.rand(1, size // 8, size // 8, 1).astype(np.float32),
        "r_center_map": rng.rand(1, size // 8, size // 8, 1).astype(np.float32),
    }


@pytest.mark.parametrize("det", [(True, True), (True, False), (False, False)])
def test_aux_views_equal_jax(det):
    rng = np.random.RandomState(sum(det))
    size = 128
    meta = img_preprocess((rng.rand(90, 120, 3) * 255).astype(np.uint8),
                          "f.jpg", input_size=size)
    out = _host_out(rng, det, size)
    faces = np.zeros((2, 4, 3), np.int64)
    jv = jvis.Visualizer(JaxConfig(configs_yml=""), faces)
    tv = tvis.Visualizer(Config(configs_yml=""), faces, device="cpu")
    want = jv.aux_views(out, meta, AUX)
    got = tv.aux_views(out, meta, AUX)
    assert list(got) == list(want) == list(AUX)
    for item in AUX:
        assert got[item].dtype == want[item].dtype == np.uint8
        np.testing.assert_array_equal(got[item], want[item], err_msg=item)
    if any(det):
        assert (got["pj2d"] != got["org_img"]).any()
    # without the maps, no centermap view (JAX skips it too)
    no_maps = {k: v for k, v in out.items() if "center_map" not in k}
    assert list(tv.aux_views(no_maps, meta, AUX)) == \
        list(jv.aux_views(no_maps, meta, AUX)) == ["org_img", "pj2d", "j3d"]


def test_plotter_equal_jax():
    rng = np.random.RandomState(4)
    poses = [rng.randn(21, 3).astype(np.float32) * 0.1 for _ in range(2)]
    for kw in (dict(), dict(canvas_size=(96, 160), scale=120.0)):
        jp, tp = jsk.Plotter3dPoses(**kw), tsk.Plotter3dPoses(**kw)
        np.testing.assert_array_equal(tp.encircle_plot(poses),
                                      jp.encircle_plot(poses))
        np.testing.assert_array_equal(
            tp.plot(poses, theta=0.3, phi=1.1),
            jp.plot(poses, theta=0.3, phi=1.1))


def test_image_mode_aux_files_match_jax(flat, tmp_path):
    import cv2
    rng = np.random.RandomState(5)
    img = tmp_path / "hands.png"
    cv2.imwrite(str(img), (rng.rand(96, 128, 3) * 255).astype(np.uint8))
    kw = dict(input_size=128, render_size=128, mano_model_path=MANO_DIR,
              configs_yml="", renderer="tpu", centermap_conf_thresh=-1e9,
              demo_mode="image", inputs=str(img), show_items=SHOW)
    japp = JaxACRApp(JaxConfig(output_dir=str(tmp_path / "jax") + "/",
                               s2d_highres=False, s2d_segm=False,
                               s2d_stem=False, merged_heads=False, **kw),
                     params=unflatten_params(flat))
    japp.run()
    app = ACRApp(Config(output_dir=str(tmp_path / "port") + "/", **kw),
                 params=from_flax(flat), device="cpu")
    app.run()
    names = sorted(os.listdir(app.output_dir))
    assert names == sorted(os.listdir(japp.output_dir)) == sorted(
        ["hands.png"] + [f"hands_{item}.png" for item in AUX])
    assert app.last_output["l_center_map"].dtype == np.float32
    for name in names:
        got = cv2.imread(os.path.join(app.output_dir, name)).astype(float)
        want = cv2.imread(os.path.join(japp.output_dir, name)).astype(float)
        assert got.shape == want.shape, name
        assert np.abs(got - want).mean() < 1.0, name
    # org_img is the network input itself: equal bytes
    assert (open(os.path.join(app.output_dir, "hands_org_img.png"), "rb").read()
            == open(os.path.join(japp.output_dir, "hands_org_img.png"),
                    "rb").read())


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    import cv2
    d = tmp_path_factory.mktemp("aux_frames")
    rng = np.random.RandomState(12)
    for i in range(3):
        cv2.imwrite(str(d / f"{i:06d}.jpg"),
                    (rng.rand(96, 128, 3) * 255).astype(np.uint8))
    return str(d)


@pytest.mark.parametrize("precision,quantize", [
    ("bf16", "none"), ("fp32", "int8")])
def test_folder_b2_matches_per_frame(flat, tmp_path, frames_dir, precision,
                                     quantize):
    sd = from_flax(flat)
    runs = {}
    for bs in (1, 2):
        cfg = Config(input_size=128, render_size=128, mano_model_path=MANO_DIR,
                     configs_yml="", renderer="tpu", centermap_conf_thresh=-1e9,
                     demo_mode="folder", inputs=frames_dir, val_batch_size=bs,
                     temporal_optimization=True, model_precision=precision,
                     quantize=quantize, show_items=SHOW,
                     output_dir=str(tmp_path / f"b{bs}") + "/")
        app = ACRApp(cfg, params=sd, device="cpu")
        runs[bs] = (app.run(), sorted(os.listdir(app.output_dir)))
    (r1, files1), (r2, files2) = runs[1], runs[2]
    assert files1 == files2
    assert sum(f.endswith("_centermap.jpg") for f in files2) == 3
    assert r1.keys() == r2.keys() and len(r1) == 3
    for path in r1:
        assert len(r1[path]) == len(r2[path]) == 2
        for h1, h2 in zip(r1[path], r2[path]):
            for key in h1:
                np.testing.assert_allclose(
                    np.float32(h1[key]), np.float32(h2[key]), rtol=2e-3,
                    atol=2e-3, err_msg=f"{path}:{key}")


def test_cli_video_mode_bf16_int8(flat, tmp_path):
    """The CLI in video mode with -t, bf16+int8 at val_batch_size 2 and
    the aux views: every frame's results and views are written."""
    import cv2
    from acr_tpu_torch.cli import main
    clip = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (128, 96))
    rng = np.random.RandomState(13)
    for _ in range(3):
        writer.write((rng.rand(96, 128, 3) * 255).astype(np.uint8))
    writer.release()
    ckpt = tmp_path / "ckpt.npz"
    np.savez(ckpt, **flat)
    out_dir = str(tmp_path / "out") + "/"
    results = main(["--demo_mode", "video", "--inputs", clip, "-t",
                    "--model_precision", "bf16", "--quantize", "int8",
                    "--val_batch_size", "2", "--show_items", "mesh", "pj2d",
                    "centermap", "--input_size", "128", "--render_size",
                    "128", "--centermap_conf_thresh=-1e9", "--model_path",
                    str(ckpt), "--mano_model_path", MANO_DIR,
                    "--output_dir", out_dir, "--device", "cpu"])
    assert len(results) == 3
    assert all(len(hands) == 2 for hands in results.values())
    written = os.listdir(out_dir)
    for item in ("pj2d", "centermap"):
        assert sum(f.endswith(f"_{item}.jpg") for f in written) == 3, item


@pytest.mark.parametrize("precision,quantize", [("bf16", "none"),
                                                ("bf16", "int8_pc")])
def test_webcam_stream_precision(flat, precision, quantize):
    """Webcam mode's StreamingLoop with -t in bf16 and bf16+int8_pc: every
    frame is delivered, finite, and the OneEuro state advances."""
    from acr_tpu_torch.pipeline.streaming import StreamingLoop, SyntheticSource
    cfg = Config(input_size=128, render_size=128, mano_model_path=MANO_DIR,
                 configs_yml="", renderer="tpu", centermap_conf_thresh=-1e9,
                 demo_mode="webcam", temporal_optimization=True,
                 interactive_vis=False, model_precision=precision,
                 quantize=quantize, show_items=SHOW)
    app = ACRApp(cfg, params=from_flax(flat), device="cpu")
    outs = []
    loop = StreamingLoop(app, on_result=lambda img, out: outs.append(out))
    assert loop.run(SyntheticSource(3, 96, 128, seed=2)) == 3
    assert len(outs) == 3 and bool(app.filter_state.left.pose.initialized)
    for out in outs:
        assert np.isfinite(out["verts"]).all() and out["detection_flag"].all()
        assert "l_center_map" not in out          # the stream shows the mesh
        assert out["_rgba"][3].any()
