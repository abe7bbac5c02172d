"""The batch-1 step through CUDA graphs (``pipeline/graphs.py``) and the
MANO indexing that lets a graph hold it. This file imports nothing of the
JAX package, so it also collects on a GPU host where flax does not import.

On the CPU (tier 1):
- ``models/mano.py`` with slices and device index tensors gives outputs
  identical to the Python-list-indexed version it replaced, left and
  right, 1 and 8 hands (the MANO tests against ``acr_tpu`` are in
  ``tests/test_torch_port_mano.py``);
- the stream step never captures on the CPU: every stage counts an eager
  step with the reason ``cpu``.

On the card (marked ``cuda``; they skip without one), ``init_params``
weights with both hands forced detected, 512 px input:
- eight stream steps with ``-t`` replayed equal eight eager ones bit for
  bit, the OneEuro state included, in the overlay configuration (render
  512, probe on) and in tracking (no visualizer);
- frame k-1's outputs are unchanged after frame k's replay;
- a replayed step makes no host wait (``set_sync_debug_mode("error")``);
- at render 1024 the render stays eager (reason ``render_size``) and the
  step still equals the eager one;
- a capture that fails leaves that stage eager and the step correct;
- frame k-1's readback waits for its own event, not for frame k and
  50 ms of device work queued behind it;
- over eight frames each delivered dict equals eager bit for bit and stays
  so after later frames, overlay and tracking;
- the step's pinned copies and event are enqueued without a host wait;
- over 200 frames that keep only ``verts``, the pinned memory held grows
  by those arrays alone, every frame reads back on its event and no
  input staging waits for its pinned buffer.
"""

import os
import time

import numpy as np
import pytest
import torch

from acr_tpu_torch.config import Config
from acr_tpu_torch.models import mano as tm
from acr_tpu_torch.ops import mano_kernel as mk
from acr_tpu_torch.pipeline import graphs
from acr_tpu_torch.pipeline import infer
from acr_tpu_torch.pipeline.app import READBACK, ACRApp, StreamOutputs
from acr_tpu_torch.pipeline.preprocess import img_preprocess
from acr_tpu_torch.pipeline.streaming import StreamingLoop, SyntheticSource
from acr_tpu_torch.viz import raster_cuda as rc
from test_torch_port_precision_cuda import _weights

MANO_DIR = os.path.join(os.path.dirname(__file__), "..", "model_data", "mano")
FRAME_HW = (480, 640)
STEPS = 8


# --- MANO: slices and device index tensors against the list indices ---

LISTS = {"LEV1": [1, 4, 7, 10, 13], "LEV2": [2, 5, 8, 11, 14],
         "LEV3": [3, 6, 9, 12, 15]}


def skinning_by_lists(rotmats, j_rest):
    """``skinning_transforms`` as it indexed with Python lists."""
    lev1, lev2, lev3 = LISTS["LEV1"], LISTS["LEV2"], LISTS["LEV3"]
    root_j = j_rest[:, 0]
    g_root = tm._with_translation(rotmats[:, 0], root_j)
    rel1 = tm._with_translation(rotmats[:, lev1], j_rest[:, lev1] - root_j[:, None])
    rel2 = tm._with_translation(rotmats[:, lev2], j_rest[:, lev2] - j_rest[:, lev1])
    rel3 = tm._with_translation(rotmats[:, lev3], j_rest[:, lev3] - j_rest[:, lev2])
    g1 = torch.einsum("bij,bfjk->bfik", g_root, rel1)
    g2 = torch.einsum("bfij,bfjk->bfik", g1, rel2)
    g3 = torch.einsum("bfij,bfjk->bfik", g2, rel3)
    g_all = torch.cat([g_root[:, None], g1, g2, g3], dim=1)[:, list(tm.REORDER_16)]
    j_h = torch.cat([j_rest, torch.zeros_like(j_rest[..., :1])], dim=-1)
    shifted = torch.einsum("bjik,bjk->bji", g_all, j_h)
    g_skin = g_all.clone()
    g_skin[..., 3] = g_skin[..., 3] - shifted
    return g_all, g_skin


def joints_by_lists(g_all, verts, tips, center_idx):
    """``joints_and_align`` as it indexed with a Python list."""
    joints16 = g_all[:, :, :3, 3]
    joints21 = torch.cat([joints16, verts[:, tips]], dim=1)[:, list(tm.REORDER_21)]
    center = None
    if center_idx is not None:
        center = joints21[:, center_idx:center_idx + 1]
        joints21 = joints21 - center
        verts = verts - center
    return verts, joints21, center


def test_mano_levels_are_the_lists():
    for name, rows in LISTS.items():
        assert list(range(16))[getattr(tm, name)] == rows


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("batch", [1, 8])
def test_mano_index_tensors_equal_lists(side, batch, monkeypatch):
    model, _ = tm.load_mano_model(MANO_DIR, side, device="cpu")
    rng = np.random.RandomState(batch)
    poses = torch.from_numpy((rng.randn(batch, 48) * 0.4).astype(np.float32))
    betas = torch.from_numpy(rng.randn(batch, 10).astype(np.float32))
    kernel = mk.build_kernel_data(model)
    got = [tm.mano_forward(model, poses, betas),
           mk.mano_forward_fused(kernel, poses, betas)]
    monkeypatch.setattr(tm, "skinning_transforms", skinning_by_lists)
    monkeypatch.setattr(tm, "joints_and_align", joints_by_lists)
    monkeypatch.setattr(mk, "skinning_transforms", skinning_by_lists)
    monkeypatch.setattr(mk, "joints_and_align", joints_by_lists)
    want = [tm.mano_forward(model, poses, betas),
            mk.mano_forward_fused(kernel, poses, betas)]
    for g_path, w_path in zip(got, want):
        for g, w in zip(g_path, w_path):
            assert torch.equal(g, w)


# --- the step ---

def _cfg(tmp_path, name, render_size=512, visual=True, size=512, **over):
    kw = dict(input_size=size, render_size=render_size,
              mano_model_path=MANO_DIR, configs_yml="", renderer="tpu",
              centermap_conf_thresh=-1e9, demo_mode="webcam",
              temporal_optimization=True, raster_overflow_every=1,
              save_visualization_on_img=visual,
              output_dir=str(tmp_path / name) + "/")
    kw.update(over)
    return Config(**kw)


def _frames(n=STEPS):
    return SyntheticSource(n, *FRAME_HW, seed=5).frames


class Frames:
    """A frame source over a list of frames."""

    def __init__(self, frames):
        self.frames = list(frames)

    def read(self):
        return self.frames.pop(0) if self.frames else None


def _run(app, frames):
    """The frames through ``StreamingLoop``: each frame's host outputs."""
    outs = []
    StreamingLoop(app, on_result=lambda img, out: outs.append(out)).run(
        Frames(frames))
    return outs


def _state(app):
    leaves = []

    def walk(tree):
        if isinstance(tree, torch.Tensor):
            leaves.append(tree.cpu())
        else:
            for t in tree:
                walk(t)
    walk(app.filter_state)
    return leaves


def _eager(app):
    """Keep ``app`` eager: its pipeline reports every step as a chunk."""
    app.pipeline.graph_block = lambda batch: "batch"
    return app


def assert_same_steps(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_cpu_step_never_captures(tmp_path):
    app = ACRApp(_cfg(tmp_path, "cpu", render_size=64, size=64),
                 params=_weights(), device="cpu")
    graphs.reset_counts()
    outs = _run(app, _frames(3))
    assert len(outs) == 3 and all("_rgba" in o for o in outs)
    assert dict(graphs.COUNTS) == {"forward.eager.cpu": 3,
                                   "smooth.eager.cpu": 3,
                                   "render.eager.cpu": 3}
    for stage in (app.pipeline._graph, app._smooth_graph, app._render_graph):
        assert not stage._keys


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("visual", [True, False], ids=["overlay", "tracking"])
def test_replay_equals_eager(tmp_path, visual):
    _need_card()
    params = _weights()
    frames = _frames()
    eager = _eager(ACRApp(_cfg(tmp_path, "eager", visual=visual),
                          params=params, device="cuda"))
    want = _run(eager, frames)
    graphed = ACRApp(_cfg(tmp_path, "graphed", visual=visual), params=params,
                     device="cuda")
    graphs.reset_counts()
    rc.reset_launch_counts()
    got = _run(graphed, frames)
    assert_same_steps(got, want)
    for g, w in zip(_state(graphed), _state(eager)):
        assert torch.equal(g, w)
    stages = ("forward", "smooth") + (("render",) if visual else ())
    want_counts = {}
    for stage in stages:
        want_counts.update({f"{stage}.eager.warmup": 1, f"{stage}.capture": 1,
                            f"{stage}.replay": STEPS - 1})
    assert dict(graphs.COUNTS) == want_counts
    # a replay counts the kernel launches it holds
    assert rc.LAUNCHES["raster_binned"] == (STEPS if visual else 0)


def _steps(app, frames):
    return [img_preprocess(f, None, app.cfg.input_size) for f in frames]


@pytest.mark.cuda
def test_replay_leaves_previous_outputs(tmp_path):
    _need_card()
    app = ACRApp(_cfg(tmp_path, "prev"), params=_weights(), device="cuda")
    metas = _steps(app, _frames(5))
    graphs.reset_counts()
    for meta in metas[:2]:                          # warm-up, capture
        app.unpack_stream(app.stream_step(meta))
    prev = app.stream_step(metas[2])
    kept = {k: v.clone() for k, v in prev.items()}
    for meta in metas[3:]:
        app.stream_step(meta)
    torch.cuda.synchronize()
    assert set(prev) == set(kept)
    for k in kept:
        assert torch.equal(prev[k], kept[k]), k
    assert graphs.COUNTS["forward.replay"] == 4


@pytest.mark.cuda
def test_replayed_step_waits_for_nothing(tmp_path):
    _need_card()
    app = ACRApp(_cfg(tmp_path, "sync"), params=_weights(), device="cuda")
    metas = _steps(app, _frames(3))
    for meta in metas[:2]:
        app.unpack_stream(app.stream_step(meta))
    graphs.reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = app.stream_step(metas[2])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    app.unpack_stream(out)
    assert dict(graphs.COUNTS) == {"forward.replay": 1, "smooth.replay": 1,
                                   "render.replay": 1}


@pytest.mark.cuda
def test_render_1024_stays_eager(tmp_path):
    _need_card()
    params = _weights()
    frames = _frames(4)
    want = _run(_eager(ACRApp(_cfg(tmp_path, "e1024", render_size=1024),
                              params=params, device="cuda")), frames)
    app = ACRApp(_cfg(tmp_path, "g1024", render_size=1024), params=params,
                 device="cuda")
    graphs.reset_counts()
    got = _run(app, frames)
    assert_same_steps(got, want)
    assert graphs.COUNTS["render.eager.render_size"] == 4
    assert graphs.COUNTS["forward.replay"] == 3
    assert graphs.COUNTS["smooth.replay"] == 3
    assert not any(k.startswith("render.") and k != "render.eager.render_size"
                   for k in graphs.COUNTS)


@pytest.mark.cuda
def test_failed_capture_stays_eager(tmp_path, monkeypatch):
    _need_card()
    params = _weights()
    frames = _frames(4)
    want = _run(_eager(ACRApp(_cfg(tmp_path, "ef"), params=params,
                              device="cuda")), frames)
    forward = infer.forward_fn

    def unsafe(*a, **k):          # a host wait, which no capture may hold
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()
        return forward(*a, **k)

    monkeypatch.setattr(infer, "forward_fn", unsafe)
    app = ACRApp(_cfg(tmp_path, "gf"), params=params, device="cuda")
    graphs.reset_counts()
    got = _run(app, frames)
    assert_same_steps(got, want)
    assert graphs.COUNTS["forward.eager.capture_failed"] == 3
    assert "forward.capture" not in graphs.COUNTS
    assert "forward.replay" not in graphs.COUNTS
    assert graphs.COUNTS["smooth.replay"] == 3
    assert graphs.COUNTS["render.replay"] == 3


# --- the readback on the step's own event ---

@pytest.mark.cuda
def test_readback_waits_for_its_own_event(tmp_path):
    _need_card()
    app = ACRApp(_cfg(tmp_path, "event"), params=_weights(), device="cuda")
    metas = _steps(app, _frames(4))
    for meta in metas[:2]:                          # warm-up, capture
        app.unpack_stream(app.stream_step(meta))
    prev = app.stream_step(metas[2])
    time.sleep(0.2)                                 # frame k-1's step runs
    cur = app.stream_step(metas[3])
    torch.cuda._sleep(100_000_000)                  # about 50 ms at 2 GHz
    slept = torch.cuda.Event()
    slept.record()
    READBACK.clear()
    t0 = time.perf_counter()
    out = app.unpack_stream(prev)
    waited_ms = (time.perf_counter() - t0) * 1e3
    busy = not slept.query()
    app.unpack_stream(cur)
    assert busy, "the device work queued behind frame k-1 had already run"
    assert waited_ms < 5.0, waited_ms
    assert READBACK["event"] == 2 and "sync" not in READBACK
    assert out["verts"].shape == (1, 2, 778, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("visual", [True, False], ids=["overlay", "tracking"])
def test_delivered_outputs_stay_eager(tmp_path, visual):
    _need_card()
    params = _weights()
    frames = _frames()
    want = _run(_eager(ACRApp(_cfg(tmp_path, "eager", visual=visual),
                              params=params, device="cuda")), frames)
    app = ACRApp(_cfg(tmp_path, "event", visual=visual), params=params,
                 device="cuda")
    got, at_delivery = [], []

    def keep(img, out):
        got.append(out)
        at_delivery.append({k: v.copy() for k, v in out.items()})
        assert_same_steps(at_delivery[-1:], want[len(got) - 1:len(got)])

    READBACK.clear()
    StreamingLoop(app, on_result=keep).run(Frames(frames))
    torch.cuda.synchronize()
    assert_same_steps(got, at_delivery)
    assert_same_steps(got, want)
    assert dict(READBACK).get("event") == STEPS and "sync" not in READBACK


@pytest.mark.cuda
def test_step_copies_wait_for_nothing(tmp_path):
    _need_card()
    app = ACRApp(_cfg(tmp_path, "copies"), params=_weights(), device="cuda")
    metas = _steps(app, _frames(3))
    for meta in metas[:2]:
        app.unpack_stream(app.stream_step(meta))
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = app.stream_step(metas[2])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert isinstance(out, StreamOutputs)
    assert set(out.host) == set(out)
    for k, v in out.host.items():
        assert v.is_pinned() and v.shape == out[k].shape, k
    got = app.unpack_stream(out)
    assert np.array_equal(got["verts"], out["verts"].cpu().numpy())


def _pinned_bytes():
    stats = getattr(torch.cuda, "host_memory_stats", lambda: {})()
    return stats.get("allocated_bytes.current")


@pytest.mark.cuda
def test_kept_outputs_hold_only_their_memory(tmp_path):
    _need_card()
    n = 200
    app = ACRApp(_cfg(tmp_path, "keep"), params=_weights(), device="cuda")
    StreamingLoop(app).run(Frames(_frames(3)))      # warm-up, capture
    torch.cuda.synchronize()
    before = _pinned_bytes()
    graphs.reset_counts()
    READBACK.clear()
    kept, sizes = [], []

    def keep(img, out):
        kept.append(out["verts"][0])
        sizes.append(sum(_block(v.nbytes) for v in out.values()))

    StreamingLoop(app, on_result=keep).run(Frames(_frames(n)))
    assert len(kept) == n
    assert READBACK["event"] == n and "sync" not in READBACK
    assert not [k for k in graphs.COUNTS if k.endswith("input_wait")]
    verts = kept[0].nbytes
    for v in kept:
        base = v.base
        while isinstance(base, np.ndarray):
            base = base.base
        assert isinstance(base, torch.Tensor) and base.is_pinned()
        assert base.numel() * base.element_size() == verts
    after = _pinned_bytes()
    if before is not None and after is not None:
        # each kept array's own block, and a few frames' outputs in
        # flight or cached: not a frame's 4 MB RGBA per kept array
        assert after - before <= n * _block(verts) + 4 * max(sizes), (
            after - before)


def _block(nbytes):
    """The caching host allocator's block: the next power of two."""
    return 1 << (nbytes - 1).bit_length()
