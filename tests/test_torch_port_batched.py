"""The port's throughput path (folder mode at val_batch_size > 1) against
the JAX package and against itself.

Five 96x128 frames from a numpy seed, 128 px input and render,
``val_batch_size=2`` (three chunks, the last one padded), the flax
weights of ``tests/test_torch_port_app.py`` (both hands plausible and
inside the frame) with both hands forced detected. Tolerances:
reference-format results to float16 resolution (as
``tests/test_torch_port_stream.py``), the OneEuro state 1e-5, b2 against
b1 rtol/atol 2e-3 (tests/test_batched_video.py:81-83), the fused MANO
path against the pure one 1e-5.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax

from acr_tpu.config import Config as JaxConfig
from acr_tpu.io.params import unflatten_params
from acr_tpu.pipeline.app import ACRApp as JaxACRApp
from acr_tpu_torch.config import Config
from acr_tpu_torch.io.params import from_flax
from acr_tpu_torch.pipeline import app as app_mod
from acr_tpu_torch.pipeline.app import ACRApp, probe_reduce
from acr_tpu_torch.pipeline.preprocess import img_preprocess
from test_torch_port_app import MANO_DIR, flat  # noqa: F401 (fixture)
from test_torch_port_stream import assert_same_results, state_leaves

torch.set_num_threads(2)
N_FRAMES = 5


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    import cv2
    d = tmp_path_factory.mktemp("batched_frames")
    rng = np.random.RandomState(11)
    for i in range(N_FRAMES):
        cv2.imwrite(str(d / f"{i:06d}.jpg"),
                    (rng.rand(96, 128, 3) * 255).astype(np.uint8))
    return str(d)


def _kw(tmp_path, name, frames_dir, **over):
    kw = dict(input_size=128, render_size=128, mano_model_path=MANO_DIR,
              configs_yml="", renderer="tpu", centermap_conf_thresh=-1e9,
              demo_mode="folder", inputs=frames_dir, val_batch_size=2,
              output_dir=str(tmp_path / name) + "/")
    kw.update(over)
    return kw


def _port(flat, tmp_path, name, frames_dir, **over):
    return ACRApp(Config(**_kw(tmp_path, name, frames_dir, **over)),
                  params=from_flax(flat), device="cpu")


def test_folder_b2_matches_jax(flat, tmp_path, frames_dir):
    kw = dict(temporal_optimization=True, save_dict_results=True)
    japp = JaxACRApp(JaxConfig(**_kw(tmp_path, "jax", frames_dir, **kw)),
                     params=unflatten_params(flat))
    want = japp.run()
    app = _port(flat, tmp_path, "port", frames_dir, **kw)
    got = app.run()
    assert len(got) == N_FRAMES
    assert_same_results(got, want)
    # the same files: five composited frames, the results pickle, the video
    outs = sorted(os.listdir(app.output_dir))
    assert outs == sorted(os.listdir(japp.output_dir))
    assert sum(o.endswith(".jpg") for o in outs) == N_FRAMES
    assert sum(o.endswith(".mp4") for o in outs) == 1
    pkls = [o for o in outs if o.endswith(".pkl")]
    assert len(pkls) == 1
    with open(os.path.join(app.output_dir, pkls[0]), "rb") as f:
        assert set(pickle.load(f)) == set(got)
    # the OneEuro state, carried over three chunks (the padded frame of
    # the last one included), agrees leaf for leaf
    assert bool(app.filter_state.right.pose.initialized)
    g_state = state_leaves(app.filter_state)
    w_state = jax.tree.leaves(japp.filter_state)
    assert len(g_state) == len(w_state) == 24
    for g, w in zip(g_state, w_state):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)


def test_b2_matches_b1(flat, tmp_path, frames_dir):
    r1 = _port(flat, tmp_path, "b1", frames_dir, val_batch_size=1,
               temporal_optimization=True).run()
    r2 = _port(flat, tmp_path, "b2", frames_dir,
               temporal_optimization=True).run()
    assert r1.keys() == r2.keys() and len(r1) == N_FRAMES
    for path in r1:
        assert len(r1[path]) == len(r2[path]) == 2
        for h1, h2 in zip(r1[path], r2[path]):
            for key in h1:
                np.testing.assert_allclose(
                    np.float32(h1[key]), np.float32(h2[key]),
                    rtol=2e-3, atol=2e-3, err_msg=f"{path}:{key}")


def test_each_frame_preprocessed_once(flat, tmp_path, frames_dir,
                                      monkeypatch):
    calls = []

    def counted(frame, path, **kw):
        calls.append(path)
        return img_preprocess(frame, path, **kw)

    monkeypatch.setattr(app_mod, "img_preprocess", counted)
    app = _port(flat, tmp_path, "once", frames_dir)
    assert len(app.run()) == N_FRAMES
    assert len(calls) == N_FRAMES and len(set(calls)) == N_FRAMES


def test_producer_error_surfaces_in_consumer(flat, tmp_path, frames_dir,
                                             monkeypatch):
    calls = []

    def failing(frame, path, **kw):
        calls.append(path)
        if len(calls) == 3:             # the first frame of the second chunk
            raise OSError(f"cannot decode {path}")
        return img_preprocess(frame, path, **kw)

    monkeypatch.setattr(app_mod, "img_preprocess", failing)
    app = _port(flat, tmp_path, "err", frames_dir)
    with pytest.raises(OSError, match="cannot decode"):
        app.run()
    assert len(calls) == 3


def _chunk(frames_dir, n=2):
    import cv2
    names = sorted(os.listdir(frames_dir))[:n]
    metas = [img_preprocess(cv2.imread(os.path.join(frames_dir, p)), p,
                            input_size=128) for p in names]
    return (np.concatenate([m["image"] for m in metas]),
            np.concatenate([m["offsets"] for m in metas]))


def test_fused_mano_on_and_off_agree(flat, tmp_path, frames_dir):
    image, offsets = _chunk(frames_dir)
    outs = {}
    for mode in ("on", "off"):
        app = _port(flat, tmp_path, mode, frames_dir, use_pallas_mano=mode,
                    temporal_optimization=True)
        for _ in range(2):              # the second chunk smooths
            out = app.chunk_step(image, offsets)
        outs[mode] = out
    for key in ("verts", "j3d", "verts_camed", "pj2d", "pj2d_org",
                "cam_trans", "poses", "betas"):
        np.testing.assert_allclose(outs["on"][key].numpy(),
                                   outs["off"][key].numpy(), atol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(outs["on"]["_rgba"].numpy(),
                               outs["off"]["_rgba"].numpy(), atol=1e-3)


def test_chunk_probe_reduction(flat, tmp_path, frames_dir):
    image, offsets = _chunk(frames_dir, n=3)
    app = _port(flat, tmp_path, "probe", frames_dir, val_batch_size=3,
                raster_overflow_every=1)
    out = app.chunk_step(image, offsets)
    per_frame = torch.stack([app.visualizer.overflow_probe_device(out, k)
                             for k in range(3)])
    want = [int(per_frame[:, 0].max()), int(per_frame[:, 1].sum()),
            int(per_frame[:, 2].max()), int(per_frame[:, 3].sum())]
    assert out["_raster_overflow"].dtype == torch.int32
    assert out["_raster_overflow"].tolist() == want
    assert want[0] > 0 and out["_rgba"].shape == (3, 4, 128, 128)
    rows = torch.tensor([[5, 1, 0, 0], [9, 0, 7, 2], [3, 4, 8, 1]],
                        dtype=torch.int32)
    assert probe_reduce(rows).tolist() == [9, 5, 8, 3]
