"""Data parallelism and the native host paths on the card (marked
``cuda``; they skip without one). This file imports nothing of the JAX
package, so it also collects on a GPU host where flax does not import.

``init_params`` weights with the fuse convs biased so both hands are
plausible (``tests/test_torch_port_precision_cuda.py``), 128 px input and
render, numpy-seeded frames, both hands forced detected.
- The sharded chunk step over two replicas on one card
  (``devices=["cuda:0", "cuda:0"]``) equals one replica's on the card at
  tests/test_parallel.py's tolerances, with the probe, and launches the
  binned rasterizer once per frame and the fused MANO kernel once per
  side and replica (4 hands each: ``use_pallas_mano="on"``).
- The device render, repeated on one frame, is bit for bit the same.
- Image mode with ``renderer='native'`` and the host solve on the card
  against the same app on the CPU: results to 1e-4 (verts and the
  solved ``cam_trans``), no rasterizer launch.
"""

import os

import numpy as np
import pytest
import torch

from acr_tpu_torch.config import Config
from acr_tpu_torch.ops import mano_kernel as mk
from acr_tpu_torch.pipeline.app import ACRApp
from acr_tpu_torch.viz import raster_cuda as rc
from test_torch_port_precision_cuda import _weights

MANO_DIR = os.path.join(os.path.dirname(__file__), "..", "model_data", "mano")
SIZE = 128
ATOL = {"_rgba": 1.5 / 255, "cam_trans": 5e-3, "pj2d_org": 2e-3}


def assert_same_chunk(got, want):
    """Two chunks' host outputs, leaf for leaf: the flags and the probe
    equal, every other leaf within ``ATOL`` (2e-4 where unnamed)."""
    assert set(got) == set(want)
    for k in want:
        if want[k].dtype == bool or k == "_raster_overflow":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k],
                                       atol=ATOL.get(k, 2e-4), err_msg=k)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and the card's replicas")


def _cfg(tmp_path, name, **over):
    kw = dict(input_size=SIZE, render_size=SIZE, mano_model_path=MANO_DIR,
              configs_yml="", renderer="tpu", centermap_conf_thresh=-1e9,
              demo_mode="folder", val_batch_size=8, use_pallas_mano="on",
              raster_overflow_every=1, output_dir=str(tmp_path / name) + "/")
    kw.update(over)
    return Config(**kw)


@pytest.mark.cuda
def test_dp_chunk_on_one_card(tmp_path):
    _need_card()
    rng = np.random.RandomState(0)
    image = (rng.rand(8, SIZE, SIZE, 3) * 255).astype(np.uint8)
    offsets = np.tile(np.array([[SIZE, SIZE, 0, 0, 0, 0, 0, 0, 0, 0]],
                               np.float32), (8, 1))
    params = _weights()
    one = ACRApp(_cfg(tmp_path, "one"), params=params, device="cuda")
    dp = ACRApp(_cfg(tmp_path, "dp", data_parallel=2), params=params,
                devices=["cuda:0", "cuda:0"])
    assert dp._sharded_chunk and len(dp.pipeline.replicas) == 2
    want = {k: v.cpu().numpy() for k, v in one.chunk_step(image, offsets).items()}
    rc.reset_launch_counts()
    mk.reset_launch_counts()
    got = {k: v.cpu().numpy() for k, v in dp.chunk_step(image, offsets).items()}
    assert rc.LAUNCHES["raster_binned"] == 8
    assert mk.LAUNCHES["mano_fused"] == 4
    assert got["_rgba"][:, 3].any()
    assert_same_chunk(got, want)


@pytest.mark.cuda
def test_render_repeats_bit_for_bit_on_card():
    """The device render of one frame, repeated, gives the same pixels
    (the vertex normals' sums in a fixed order, ROADMAP C7)."""
    _need_card()
    from acr_tpu_torch.models.mano import load_mano_model, mano_forward
    from acr_tpu_torch.viz.raster import compute_vertex_normals, render_hands
    gen = torch.Generator().manual_seed(0)
    verts, faces = [], []
    for side in ("left", "right"):
        model, f = load_mano_model(MANO_DIR, side, device="cuda")
        v, _, _ = mano_forward(model, (torch.randn(1, 48, generator=gen)
                                       * 0.5).cuda(),
                               torch.randn(1, 10, generator=gen).cuda())
        verts.append(v[0])
        faces.append(torch.as_tensor(f, dtype=torch.long, device="cuda"))
    verts, faces = torch.stack(verts), torch.stack(faces)
    cam = torch.tensor([[-0.08, 0.0, 0.5], [0.08, 0.0, 0.5]], device="cuda")
    det = torch.tensor([True, True], device="cuda")
    all_v = (verts + cam[:, None]).reshape(-1, 3)
    all_f = torch.cat([faces[0], faces[1] + 778])
    n0 = compute_vertex_normals(all_v, all_f)
    r0 = render_hands(verts, cam, det, faces, size=512)
    assert r0[..., 3].any()
    for _ in range(5):
        assert torch.equal(compute_vertex_normals(all_v, all_f), n0)
        assert torch.equal(render_hands(verts, cam, det, faces, size=512), r0)


@pytest.mark.cuda
def test_native_host_paths_on_card(tmp_path):
    _need_card()
    import cv2
    img = tmp_path / "frame.jpg"
    cv2.imwrite(str(img), (np.random.RandomState(1).rand(96, 128, 3) * 255
                           ).astype(np.uint8))
    outs = {}
    for device in ("cuda", "cpu"):
        app = ACRApp(_cfg(tmp_path, device, demo_mode="image",
                          inputs=str(img), renderer="native",
                          jit_translation_solve=False),
                     params=_weights(), device=device)
        rc.reset_launch_counts()
        app.run()
        assert not any(rc.LAUNCHES.values())
        outs[device] = app.last_output
        assert os.listdir(app.output_dir) == ["frame.jpg"]
    for k in ("verts", "j3d", "cam_trans"):
        np.testing.assert_allclose(outs["cuda"][k], outs["cpu"][k],
                                   atol=1e-4, err_msg=k)
