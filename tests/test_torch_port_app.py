"""Port ACRApp.process_frame against JAX ACRApp.process_frame on the CPU.

One frame from a numpy seed, both hands forced detected
(centermap_conf_thresh below every score), 128 px input and render, on
flax weights whose parameter-emitting convs are biased so that both
hands are plausible and visible (``visible_hands``).
The results dicts (float16, as the reference writes them) must agree to
float16 resolution, and the RGBA renders as stated below. Also: the CLI's image
mode end to end on a flax-path checkpoint.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acr_tpu.config import Config as JaxConfig
from acr_tpu.io.params import flatten_params
from acr_tpu.models.acr import ACRNet as JaxACRNet
from acr_tpu.pipeline.app import ACRApp as JaxACRApp
from acr_tpu.pipeline.preprocess import img_preprocess
from acr_tpu_torch.config import Config
from acr_tpu_torch.io.params import from_flax
from acr_tpu_torch.pipeline.app import ACRApp

torch.set_num_threads(2)
MANO_DIR = os.path.join(os.path.dirname(__file__), "..", "model_data", "mano")


@pytest.fixture(scope="module")
def flat():
    params = JaxACRNet().init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 32, 3), jnp.uint8))
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 0.2 if getattr(p[-1], "key", None) == "scale" else x,
        params)
    return visible_hands(flatten_params(params))


def visible_hands(flat, scale=3.0):
    """Damp the fuse convs that emit each hand's 109 parameters and bias
    them to the camera (scale, -+0.3, 0), identity 6D rotations and zero
    betas, so that both hands are plausible and inside the frame."""
    flat = dict(flat)
    rot6d = np.tile(np.array([1, 0, 0, 1, 0, 0], np.float32), 16)
    for side, tx in (("l", -0.3), ("r", 0.3)):
        k = flat[f"{side}_fuse_conv/kernel"] * 0.05
        k[..., :3] = 0.0
        flat[f"{side}_fuse_conv/kernel"] = k
        flat[f"{side}_fuse_conv/bias"] = np.concatenate(
            [[scale, tx, 0.0], rot6d, np.zeros(10)]).astype(np.float32)
        flat[f"{side}_prior_head/out/kernel"] = \
            flat[f"{side}_prior_head/out/kernel"] * 0.05
    return flat


def _kw(tmp_path, name):
    return dict(input_size=128, render_size=128, mano_model_path=MANO_DIR,
                configs_yml="", renderer="tpu", centermap_conf_thresh=-1e9,
                output_dir=str(tmp_path / name) + "/")


def test_process_frame_matches_jax(flat, tmp_path):
    from acr_tpu.io.params import unflatten_params
    rng = np.random.RandomState(5)
    frame = (rng.rand(96, 128, 3) * 255).astype(np.uint8)      # BGR, padded
    path = "frame_0.jpg"

    japp = JaxACRApp(JaxConfig(**_kw(tmp_path, "jax")),
                     params=unflatten_params(flat))
    want = japp.process_frame(frame, path)
    meta = img_preprocess(frame, path, input_size=128)
    jout = japp.pipeline(meta["image"], meta["offsets"])
    want_rgba = np.asarray(japp.visualizer.render_rgba_device(jout))

    app = ACRApp(Config(**_kw(tmp_path, "port")), params=from_flax(flat))
    got = app.process_frame(frame, path)
    got_rgba = app.last_output["_rgba"]

    assert got.keys() == want.keys()
    assert len(got[path]) == len(want[path]) == 2            # both hands
    for g, w in zip(got[path], want[path]):
        assert g.keys() == w.keys()
        for key in w:
            gv, wv = np.asarray(g[key]), np.asarray(w[key])
            assert gv.dtype == wv.dtype, key
            if gv.dtype == np.float16:
                np.testing.assert_allclose(
                    gv.astype(np.float32), wv.astype(np.float32),
                    rtol=2e-3, atol=1e-3, err_msg=key)
            else:
                np.testing.assert_array_equal(gv, wv, err_msg=key)
    assert got_rgba.shape == want_rgba.shape == (4, 128, 128)
    assert got_rgba[3].sum() > 500
    # the port's render of JAX's own outputs: 1e-5
    from acr_tpu_torch.viz.raster import render_hands
    same_inputs = render_hands(
        *(torch.tensor(np.asarray(jout[k][0])) for k in
          ("verts", "cam_trans", "detection_flag")),
        torch.tensor(japp.pipeline.faces.astype(np.int64)), size=128,
        focal=1265.0, planar=True)
    np.testing.assert_allclose(same_inputs.numpy(), want_rgba, atol=1e-5)
    # each side's own chain: the same coverage, shading to 1e-3. The two
    # cam_trans differ by ~2e-6 through the ill-conditioned LS solve,
    # which can move a depth tie between overlapping faces (measured
    # 2.7e-4 at 84 of 16384 pixels)
    np.testing.assert_array_equal(got_rgba[3], want_rgba[3])
    np.testing.assert_allclose(got_rgba, want_rgba, atol=1e-3)
    written = os.listdir(app.output_dir)
    assert written == [path]


def test_cli_image_mode(flat, tmp_path):
    import cv2
    from acr_tpu_torch.cli import main
    ckpt = tmp_path / "ckpt.npz"
    np.savez(ckpt, **flat)
    img = tmp_path / "hands.jpg"
    rng = np.random.RandomState(6)
    cv2.imwrite(str(img), (rng.rand(100, 80, 3) * 255).astype(np.uint8))
    out_dir = tmp_path / "out"
    results = main(["--demo_mode", "image", "--inputs", str(img),
                    "--output_dir", str(out_dir) + "/", "--model_path",
                    str(ckpt), "--input_size", "128", "--render_size", "128",
                    "--centermap_conf_thresh=-1e9", "-s",
                    "--device", "cpu"])
    assert len(results[str(img)]) == 2
    assert sorted(os.listdir(out_dir)) == ["hands.jpg",
                                           "hands.jpg_results.pkl"]
