"""Streaming loop with one frame in flight.

Counterpart of ``acr_tpu/pipeline/streaming.py``. The loop is pipelined
around PyTorch's asynchronous launches:

    frame k:   [device step .............]
    frame k+1:         [capture+preprocess] [issue]
    frame k-1: [readback, composite, deliver on the host]

``ACRApp.stream_step`` issues frame k's work (forward, OneEuro, refine,
render) without a readback, and the host composites frame k-1 while the
device runs. With ``renderer='native'`` the host draws frame k-1 there
too, through the C++ z-buffer. The render's gate reads two counts to the host, which
waits for frame k's forward to finish before the render is issued: that
read limits the overlap (a later perf item).

A frame source is anything with ``read() -> Optional[ndarray]``
(WebcamVideoStream, OpenCVCapture, or ``SyntheticSource`` in tests and
smoke runs).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Protocol

import numpy as np

from acr_tpu_torch.utils.meters import AverageMeter


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
        self.latency = AverageMeter()
        self.latencies = []

    def run(self, source: FrameSource) -> int:
        """Pipelined loop; returns the number of frames processed."""
        from acr_tpu_torch.pipeline.preprocess import img_preprocess

        app, cfg = self.app, self.app.cfg
        inflight = None          # (t_start, frame, meta, device outputs)
        count = 0
        while self.max_frames is None or count < self.max_frames:
            frame = source.read()
            if frame is None:
                break
            t0 = time.perf_counter()
            meta = img_preprocess(frame, str(count), input_size=cfg.input_size)
            out = app.stream_step(meta)
            if inflight is not None:
                self._finish(*inflight)
            inflight = (t0, frame, meta, out)
            count += 1
        if inflight is not None:
            self._finish(*inflight)
        return count

    def _finish(self, t0, frame, meta, out):
        """The frame's one readback, then composite, deliver, latency."""
        out = self.app.unpack_stream(out)
        rendered = frame
        if out["detection_flag"].any() and self.app.visualizer is not None:
            if "_rgba" in out:
                rendered = self.app.visualizer.compose_on_frame(
                    out["_rgba"], frame, meta, planar=True)
            else:               # renderer='native': drawn on the host
                rendered = self.app.visualizer.render_on_frame(
                    frame, out, meta)
        dt = (time.perf_counter() - t0) * 1000.0
        self.latency.update(dt)
        self.latencies.append(dt)
        if self.on_result is not None:
            self.on_result(rendered, out)

    def p50_latency_ms(self) -> float:
        return float(np.percentile(self.latencies, 50)) if self.latencies else 0.0
