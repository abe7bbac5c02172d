"""Streaming loop with one frame in flight.

Counterpart of ``acr_tpu/pipeline/streaming.py``. The loop is pipelined
around PyTorch's asynchronous launches:

    frame k:   [device step .............]
    frame k+1:         [capture+preprocess] [issue]
    frame k-1: [readback, composite, deliver on the host]

``ACRApp.stream_step`` issues frame k's work (forward, OneEuro, refine,
render) without a readback, and the host composites frame k-1 while the
device runs. With ``renderer='native'`` the host draws frame k-1 there
too, through the C++ z-buffer. On a card the step's forward, OneEuro
with the refine, and the render below 1024 px each replay a CUDA graph
(``pipeline.graphs``) from the second frame on, the frame's image and
offsets staged through pinned memory: issuing a frame is a handful of
launches and waits for nothing. At 1024 px and above the render runs
eagerly, since the banded render's gate reads two maxima to the host
(``viz.raster.banded_fits``), which waits for frame k's forward before
the render is issued. On a card each step ends with its outputs' copies
to pinned host memory and an event after them, so frame k-1's readback
waits for frame k-1's own work and its copies, never for frame k's,
which runs under frame k-1's composite.

Each stage of a turn is a stage of ``app.timer`` (a ``SpanTimer``) with
the frame's index as its id: ``stream.read``, ``stream.preprocess`` and
``stream.issue`` for frame k, ``stream.readback``, ``stream.composite``
and ``stream.deliver`` for frame k-1, and ``stream.frame``, from the
frame's read to its delivery, kept in memory only since it spans two
turns.

A frame source is anything with ``read() -> Optional[ndarray]``
(WebcamVideoStream, OpenCVCapture, or ``SyntheticSource`` in tests and
smoke runs).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Protocol

import numpy as np


class FrameSource(Protocol):
    def read(self) -> Optional[np.ndarray]: ...


class SyntheticSource:
    """Deterministic fake camera: ``n_frames`` uniform-noise BGR frames."""

    def __init__(self, n_frames: int, height: int = 96, width: int = 128,
                 seed: int = 0):
        rng = np.random.RandomState(seed)
        self.frames = [
            (rng.rand(height, width, 3) * 255).astype(np.uint8)
            for _ in range(n_frames)]
        self.idx = 0

    def read(self) -> Optional[np.ndarray]:
        if self.idx >= len(self.frames):
            return None
        frame = self.frames[self.idx]
        self.idx += 1
        return frame


class StreamingLoop:
    """Drives an ``ACRApp`` frame by frame with one frame in flight."""

    def __init__(self, app, on_result: Optional[Callable] = None,
                 max_frames: Optional[int] = None):
        self.app = app
        self.on_result = on_result
        self.max_frames = max_frames
        self.latencies = []

    def run(self, source: FrameSource) -> int:
        """Pipelined loop; returns the number of frames processed."""
        from acr_tpu_torch.pipeline.preprocess import img_preprocess

        app, cfg, timer = self.app, self.app.cfg, self.app.timer
        inflight = None          # (t_start, frame id, frame, meta, device outputs)
        count = 0
        while self.max_frames is None or count < self.max_frames:
            with timer.stage("stream.read", count):
                frame = source.read()
            if frame is None:
                break
            t0 = time.perf_counter()
            with timer.stage("stream.preprocess", count):
                meta = img_preprocess(frame, str(count),
                                      input_size=cfg.input_size)
            with timer.stage("stream.issue", count):
                out = app.stream_step(meta)
            if inflight is not None:
                self._finish(*inflight)
            inflight = (t0, count, frame, meta, out)
            count += 1
        if inflight is not None:
            self._finish(*inflight)
        return count

    def _finish(self, t0, fid, frame, meta, out):
        """The frame's one readback, then composite, latency, deliver."""
        app, timer = self.app, self.app.timer
        with timer.stage("stream.readback", fid):
            out = app.unpack_stream(out)
        rendered = frame
        if out["detection_flag"].any() and app.visualizer is not None:
            with timer.stage("stream.composite", fid):
                if "_rgba" in out:
                    rendered = app.visualizer.compose_on_frame(
                        out["_rgba"], frame, meta, planar=True)
                else:           # renderer='native': drawn on the host
                    rendered = app.visualizer.render_on_frame(
                        frame, out, meta)
        self.latencies.append((time.perf_counter() - t0) * 1000.0)
        if self.on_result is not None:
            with timer.stage("stream.deliver", fid):
                self.on_result(rendered, out)
        timer.add_span("stream.frame", t0, time.perf_counter(), fid)

    def p50_latency_ms(self) -> float:
        return float(np.percentile(self.latencies, 50)) if self.latencies else 0.0
