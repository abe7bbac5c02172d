"""The two drivers of the program's timed path, chosen by the traffic
file's ``driver``.

``webcam``: ``StreamingLoop.run`` over a ``PacedCamera`` (30 frames/s,
640 x 480, latest-frame rule). Each frame is timed from its capture on
the camera clock to the return of the harness's ``on_result`` for it. Of the
delivered frames' images only those judged whole are kept.

``folder``: ``ACRApp.run_folder`` (the CLI's folder mode) over seeded
720p JPEG clips written in set-up, one after another until the window
closes, a fresh OneEuro state per clip. A frame is finished when the
program emits it (written, or with no visualisation handed on after its
chunk's readback); the first emission after the close ends the clip,
and no clip starts after it. A clip with no emission at all is an error.

Both record the program's outputs of every frame for the judge (the keys
of the cell's architecture's ``KEEP``), and with
``--trace 1`` the harness's spans around the calls into the app's layers
and the profiler's sub-window. Nothing is written into the program: the
hooks wrap methods of the one app instance.
"""

from __future__ import annotations

import collections
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

from port_bench.harness import frames as F
from port_bench.harness.trace import Tracer

COMPOSITES = 5


class WindowClosed(Exception):
    """Raised from the emission hook at the first frame after the close."""


class Obs:
    """What a run observed: read by the metric files."""

    def __init__(self):
        self.setup_s = None
        self.window_s = None
        self.latencies_ms: List[float] = []
        self.delivered = 0
        self.frames_done = 0
        self.spans: Dict[str, List[float]] = collections.defaultdict(list)
        self.timer: Dict[str, Dict[str, float]] = {}
        self.batch = 1
        self.trace = None
        self.work: Dict[str, float] = {}
        self.precision = "fp32"
        self.peaks = None


def say(*parts) -> None:
    print("port_bench:", *parts, file=sys.stderr, flush=True)


class Span:
    """Host-clock spans (and profiler annotations) around an object's
    calls; ``on`` is set once the window opens."""

    def __init__(self, obs: Obs):
        self.obs, self.on = obs, False

    def wrap(self, fn, name: str):
        import torch

        def spanned(*a, **k):
            t = time.perf_counter()
            with torch.profiler.record_function(f"port_bench.{name}"):
                out = fn(*a, **k)
            if self.on:
                self.obs.spans[name].append((time.perf_counter() - t) * 1e3)
            return out
        return spanned


class PipelineSpan:
    """The app's pipeline behind a ``port_bench.forward`` annotation."""

    def __init__(self, inner, span: Span):
        self._inner, self._call = inner, span.wrap(inner, "forward")

    def __call__(self, *a, **k):
        return self._call(*a, **k)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _host(out, keep) -> Dict[str, np.ndarray]:
    return {k: (out[k].cpu().numpy() if hasattr(out[k], "cpu")
                else np.asarray(out[k])) for k in keep}


def _install_spans(app, obs: Obs) -> Span:
    span = Span(obs)
    app.pipeline = PipelineSpan(app.pipeline, span)
    return span


def webcam(run) -> Dict:
    from acr_tpu_torch.pipeline.streaming import StreamingLoop
    tr, obs, keep = run.traffic, run.obs, run.arch.KEEP
    pool = F.smooth_frames(run.seed, tr["pool"], tr["height"], tr["width"],
                          run.device)
    run.mark("inputs")
    app = run.make_app()
    run.mark("app")
    span = None
    if run.trace:
        span = _install_spans(app, obs)
        app.stream_step = span.wrap(app.stream_step, "issue")
        app.unpack_stream = span.wrap(app.unpack_stream, "readback")
        if app.visualizer is not None:
            app.visualizer.compose_on_frame = span.wrap(
                app.visualizer.compose_on_frame, "composite")
    # the delivered frames judged whole: the first delivered at or after
    # each of COMPOSITES capture numbers drawn from the seed, and the last
    # delivered in the window; only these are kept
    n_caps = int(run.seconds * tr["fps"])
    targets = sorted(np.random.default_rng(run.seed).choice(
        n_caps, size=min(n_caps, COMPOSITES), replace=False).tolist())
    state = {"source": None, "tracer": None, "deadline": None, "last": None}
    outputs, history, images, delivered = [], [], {}, []

    def on_result(rendered, out):
        cap = state["source"].pending.popleft()
        idx = len(outputs)
        outputs.append({k: v[0] for k, v in _host(out, keep).items()})
        history.append(cap.frame_id)
        t = time.perf_counter()
        if cap.index >= 0:
            delivered.append((idx, cap, t))
            if app.visualizer is not None and t <= state["deadline"]:
                state["last"] = (idx, rendered)
                if targets and cap.index >= targets[0]:
                    images[idx] = rendered
                    while targets and cap.index >= targets[0]:
                        targets.pop(0)
        if state["tracer"] is not None:
            state["tracer"].poll(t)

    loop = StreamingLoop(app, on_result=on_result)
    warm = F.ListSource(pool, list(range(tr["warm_frames"])))
    state["source"] = warm
    loop.run(warm)
    if run.trace:
        warm = F.ListSource(pool, [tr["warm_frames"] % len(pool)])
        state["source"] = warm
        Tracer(0).warm(lambda: loop.run(warm))
    run.sync()
    run.mark("warm-up")
    t0 = time.perf_counter() + 0.05
    state["deadline"] = deadline = t0 + run.seconds
    obs.setup_s = t0 - run.clock0
    if run.trace:
        state["tracer"] = Tracer(deadline - min(tr["trace_s"], run.seconds / 2))
        span.on = True
    cam = F.PacedCamera(pool, tr["fps"], t0, deadline)
    state["source"] = cam
    loop.run(cam)
    if state["tracer"] is not None:
        state["tracer"].finish()
        obs.trace = state["tracer"].summary
    obs.window_s = run.seconds
    window = [(i, c, t) for i, c, t in delivered if t <= deadline]
    obs.latencies_ms = [(t - c.captured) * 1e3 for _, c, t in window]
    gaps = np.diff([t for _, _, t in window]) * 1e3
    if len(gaps) > 4:
        half = len(gaps) // 2
        say(f"delivery interval ms: median {np.median(gaps[:half]):.1f} in the "
            f"first half, {np.median(gaps[half:]):.1f} in the second")
    obs.delivered = len(window)
    obs.frames_done = len(window)
    judged = [i for i, _, _ in window]
    if state["last"] is not None:
        images[state["last"][0]] = state["last"][1]
    del app, loop
    return {"sequences": [{
        "frames": [pool[i] for i in history], "outputs": outputs,
        "judged": judged, "composites": images}],
        "attempted": len(window)}


def folder(run) -> Dict:
    from acr_tpu_torch.pipeline.temporal import init_two_hand_filter
    tr, obs = run.traffic, run.obs
    tmp = tempfile.mkdtemp(prefix="port_bench_")
    try:
        return _folder(run, tr, obs, tmp, init_two_hand_filter)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _folder(run, tr, obs, tmp, init_filter) -> Dict:
    n = tr["frames_per_clip"]
    clips, total = [], 0
    for c in range(tr["clips"]):
        d = os.path.join(tmp, "in", f"clip{c}")
        total += F.write_clip(F.smooth_frames([run.seed, c], n, tr["height"],
                                              tr["width"], run.device),
                              d, tr["jpeg_quality"])
        clips.append(d)
    say(f"{tr['clips']} clips of {n} frames, mean JPEG {total / (n * tr['clips']):.0f} bytes")
    run.mark("inputs")
    warm_dir = os.path.join(tmp, "in", "warm")
    os.makedirs(warm_dir)
    for name in sorted(os.listdir(clips[0]))[:tr["warm_frames"]]:
        shutil.copy(os.path.join(clips[0], name), warm_dir)

    app = run.make_app()
    run.mark("app")
    obs.batch = app.cfg.val_batch_size
    span = None
    if run.trace:
        span = _install_spans(app, obs)
        app._emit_frame = span.wrap(app._emit_frame, "emit")
        if app.visualizer is not None:
            app.visualizer.compose_on_frame = span.wrap(
                app.visualizer.compose_on_frame, "composite")
    keep = set(np.random.default_rng(run.seed).choice(
        n, size=3, replace=False).tolist()) | {n - 1}
    state = {"run": -1, "deadline": None, "tracer": None}
    chunks: Dict[int, List] = collections.defaultdict(list)
    finished: Dict[int, List] = collections.defaultdict(list)
    fired: Dict[int, int] = collections.defaultdict(int)
    images: Dict[tuple, np.ndarray] = {}
    chunk_step, emit = app.chunk_step, app._emit_frame

    def chunk_hook(image, offsets):
        out = chunk_step(image, offsets)
        chunks[state["run"]].append({k: out[k] for k in run.arch.KEEP})
        return out

    def emit_hook(frame, path):
        emit(frame, path)
        fired[state["run"]] += 1
        t = time.perf_counter()
        if state["deadline"] is None:
            return
        if t > state["deadline"]:
            raise WindowClosed()
        k = int(os.path.splitext(os.path.basename(path))[0])
        finished[state["run"]].append(k)
        if app.visualizer is not None and k in keep:
            images[state["run"], k] = frame
        if state["tracer"] is not None:
            state["tracer"].poll(t)

    app.chunk_step, app._emit_frame = chunk_hook, emit_hook

    def one_clip(inputs, out_dir):
        state["run"] += 1
        app.cfg.inputs, app.cfg.output_dir = inputs, out_dir
        app.filter_state = init_filter(app.pipeline.device)
        app.run_folder()
        if not fired[state["run"]]:
            raise RuntimeError("ACRApp.run_folder finished a clip without a "
                               "call to ACRApp._emit_frame, which the harness "
                               "wraps to time each frame and close the window")

    one_clip(warm_dir, os.path.join(tmp, "out", "warm"))
    if run.trace:
        Tracer(0).warm(lambda: one_clip(warm_dir, os.path.join(tmp, "out", "warm")))
    runs_before = state["run"] + 1
    run.sync()
    run.mark("warm-up")
    before = {k: (m.sum, m.count) for k, m in app.timer.meters.meters.items()}
    t0 = time.perf_counter()
    state["deadline"] = deadline = t0 + run.seconds
    obs.setup_s = t0 - run.clock0
    if run.trace:
        state["tracer"] = Tracer(deadline - min(tr["trace_s"], run.seconds / 2))
        span.on = True
    order = []
    try:
        while time.perf_counter() <= deadline:
            c = len(order) % len(clips)
            order.append(c)
            one_clip(clips[c], os.path.join(tmp, "out", f"clip{c}"))
    except WindowClosed:
        pass
    run.sync()
    if state["tracer"] is not None:
        state["tracer"].finish()
        obs.trace = state["tracer"].summary
    after = {k: (m.sum, m.count) for k, m in app.timer.meters.meters.items()}
    obs.timer = {k: {"sum_ms": after[k][0] - before.get(k, (0, 0))[0],
                     "count": after[k][1] - before.get(k, (0, 0))[1]}
                 for k in after}
    obs.window_s = run.seconds
    obs.frames_done = sum(len(v) for r, v in finished.items() if r >= runs_before)
    # the judged clips: the last (cut by the close) and one drawn from the seed
    runs = [r for r in range(runs_before, state["run"] + 1) if finished[r]]
    rng = np.random.default_rng(run.seed)
    pick = sorted({runs[-1], int(rng.choice(runs))}) if runs else []
    sequences = []
    for r in pick:
        folder_ = clips[order[r - runs_before]]
        names = sorted(os.listdir(folder_))
        outs = []
        for ch in chunks[r]:
            host = _host(ch, run.arch.KEEP)
            outs.extend({k: v[j] for k, v in host.items()}
                        for j in range(host["verts"].shape[0]))
        import cv2
        frames = [cv2.imread(os.path.join(folder_, nm)) for nm in names[:len(outs)]]
        sequences.append({"frames": frames, "outputs": outs,
                          "judged": sorted(finished[r]),
                          "composites": {k: img for (rr, k), img in images.items()
                                         if rr == r}})
    chunks.clear()
    del app
    return {"sequences": sequences, "attempted": obs.frames_done}


DRIVERS = {"webcam": webcam, "folder": folder}
