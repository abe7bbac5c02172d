"""Streaming loop: one frame in flight, read just before the device
frees up where the device sets the pace, or each frame delivered in its
own turn where the camera leaves room for the wait.

Counterpart of ``acr_tpu/pipeline/streaming.py``. The loop is pipelined
around PyTorch's asynchronous launches. With one frame in flight:

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

Where the device step outlasts the host's turn, frame k+1 issued at
once would queue behind frame k's step and then run its own. The loop
then paces its reads: it sleeps before the read until frame k's step is
about to end, less the host's lead (read, preprocess, issue) and a
margin, so that frame k+1's work arrives as the device frees up:

    frame k:   [device step ........................]
    frame k+1:       [sleep] [capture+preprocess] [issue] [device step..
    frame k-1: [readback, deliver]

The device stays as busy, the same frames per second are delivered, and
each frame is read one queued step later, so it is that much fresher.
``PaceRule`` decides from the host time each frame's event passed, the
step's device time and the host's lead.

Frame k-1 then waits, finished, for frame k's capture. Where the read
blocks for longer than frame k's step takes, the loop drains: it
delivers each frame in the turn that issued it, waiting for the frame's
own event before the next read:

    frame k:   [capture+preprocess] [issue] [wait: device step] [readback,
                                                       composite, deliver]
    frame k+1:                                                         [capture...

``DrainRule`` decides from what the loop observes, turn by turn: how
long the read blocked (a pacing sleep included), and how long the wait
for a frame's event is. A frame on a card delivered in its own turn
measures that wait on the host (``StreamOutputs.waited_s``); a frame
left in flight gives its device time from the step's front to its
copies' event (``StreamOutputs.device_s``) less its issue's host time,
the part of the step that ran under the issue. A step with no event (on
the CPU, or outputs not on one card) is synchronous: its wait is 0, and
the loop never sleeps. Every ``run`` starts with one frame in flight,
unpaced. Either way frames are delivered in the order they were read,
and each frame's outputs are the same. ``TURNS`` counts the turns of
each kind.

Each stage of a turn is a stage of ``app.timer`` (a ``SpanTimer``) with
the frame's index as its id: ``stream.read`` (a pacing sleep included),
``stream.preprocess`` and ``stream.issue`` for frame k,
``stream.readback``, ``stream.composite`` and ``stream.deliver`` for the
frame delivered (k-1, or k when the turn drains), and ``stream.frame``,
from the frame's read to its delivery, kept in memory only since it may
span two turns.

A frame source is anything with ``read() -> Optional[ndarray]``
(WebcamVideoStream, OpenCVCapture, or ``SyntheticSource`` in tests and
smoke runs).
"""

from __future__ import annotations

import collections
import statistics
import time
from typing import Callable, Dict, Optional, Protocol, Sequence

import numpy as np

# the loop's turns: "drained", those that delivered their own frame;
# "inflight", those that left it in flight; "left", switches out of
# drain mode; "paced", those that slept before their read; "late", paced
# turns whose frame in flight had finished when their issue returned
TURNS: Dict[str, int] = collections.Counter()


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


def _spread(xs: Sequence[float]) -> float:
    """The distance between the first and third quartiles."""
    q1, _, q3 = statistics.quantiles(xs, n=4)
    return q3 - q1


class DrainRule:
    """Whether a turn delivers its own frame. Each turn the loop calls
    ``read`` with the seconds its ``source.read()`` blocked, and at the
    turn's end ``done`` with the seconds of the host's own work in it (the
    preprocess, readbacks less their waits, composites and deliveries; not
    the issue, which on a synchronous device holds the step itself), and
    the newest reading of the wait that delivering a frame in its own turn
    adds (None while none was read back).

    A turn's slack is what its read would still block had the turn before
    it drained: the block itself after a drained turn, the block less the
    wait after one that left its frame in flight. The margin is the turn's
    jitter as the loop observed it: the larger interquartile range of the
    last ``WINDOW`` slacks (under a paced camera) and of the last
    ``WINDOW`` works (where the read never blocks, so its block says
    nothing). The rule enters drain mode once the last ``ENTER`` slacks
    each exceed the margin, and leaves it at the first read that did not
    block by more than the margin: the turn outgrew the camera's period.
    A paced turn's block holds its sleep before the read (``PaceRule``):
    where the camera sets the pace, the sleep falls inside the block the
    read would have had anyway."""

    ENTER = 4
    WINDOW = 16

    def __init__(self):
        self.draining = False
        self.wait: Optional[float] = None
        self.slacks = collections.deque(maxlen=self.WINDOW)
        self.works = collections.deque(maxlen=self.WINDOW)

    def margin(self) -> float:
        return max(_spread(self.slacks), _spread(self.works))

    def read(self, blocked: float) -> bool:
        """This turn's mode from its read's block: True to drain."""
        if self.draining:
            if blocked <= self.margin():
                self.draining = False
                TURNS["left"] += 1
            self.slacks.append(blocked)
        elif self.wait is not None:
            self.slacks.append(blocked - self.wait)
            recent = list(self.slacks)[-self.ENTER:]
            self.draining = (len(recent) == self.ENTER
                             and min(recent) > self.margin())
        TURNS["drained" if self.draining else "inflight"] += 1
        return self.draining

    def done(self, work: float, wait: Optional[float]):
        """The turn's host work, and the newest wait read back in it."""
        self.works.append(work)
        if wait is not None:
            self.wait = wait


class PaceRule:
    """When a turn that has a frame in flight reads its next frame. Before
    the read the loop calls ``sleep_s`` with the host time, and sleeps the
    seconds it returns; at the turn's end ``done`` with the turn's lead
    (from the read's planned start, the sleep's end, to the issue's
    return), the seconds the readback of the frame before it waited for
    its event, that frame's device seconds (None with no event), the host
    time its event passed (None where it had passed when queried), and the
    host time the issue of the frame now in flight began.

    The frame in flight started on the device when the frame before it
    was ready, so it should end a median device time ``D`` (of the last
    ``WINDOW`` frames) after that. The read starts the 90th percentile of
    the last ``WINDOW`` leads and a margin before then, and never later than
    the last turn's slack (its sleep and wait: what it would have waited
    unpaced) less the margin. The margin is the
    larger interquartile range of the last ``WINDOW`` device times and
    leads. The rule sleeps only once the last ``ENTER`` slacks each exceed
    the margin: the host is ahead of the device. A paced turn whose frame
    before had finished when it was queried was late: the device may have
    idled, and the frame in flight started at some time between its
    issue's start and return. The next turn paces from the issue's start,
    the earliest of these, so it reads no later than it should and loses
    the device no time of its own; a late turn costs at most its own
    idle."""

    ENTER = DrainRule.ENTER
    WINDOW = DrainRule.WINDOW

    def __init__(self):
        self.start: Optional[float] = None
        self.slept = 0.0
        self.devices = collections.deque(maxlen=self.WINDOW)
        self.leads = collections.deque(maxlen=self.WINDOW)
        self.slacks = collections.deque(maxlen=self.WINDOW)

    def margin(self) -> float:
        return max(_spread(self.devices), _spread(self.leads))

    def sleep_s(self, now: float) -> float:
        """Seconds to sleep before this turn's read, from host time ``now``."""
        self.slept = 0.0
        recent = list(self.slacks)[-self.ENTER:]
        if (self.start is None or len(recent) < self.ENTER
                or len(self.devices) < self.ENTER):
            return 0.0
        margin = self.margin()
        if min(recent) <= margin:
            return 0.0
        # the 90th percentile, past the largest lead of the window
        lead = statistics.quantiles(self.leads, n=10, method="inclusive")[-1]
        end = self.start + statistics.median(self.devices)
        self.slept = max(0.0, min(end - lead - margin - now,
                                  recent[-1] - margin))
        if self.slept:
            TURNS["paced"] += 1
        return self.slept

    def done(self, lead: float, waited: float, device: Optional[float],
             ready: Optional[float], issue: float):
        """The turn's lead, the readings of the frame before the one in
        flight, and the host time the issue of the one in flight began."""
        self.leads.append(lead)
        self.slacks.append(self.slept + waited)
        if device is not None:
            self.devices.append(device)
        if self.slept and ready is None:
            TURNS["late"] += 1
        self.start = issue if ready is None else ready


class StreamingLoop:
    """Drives an ``ACRApp`` frame by frame, one frame in flight, its reads
    paced as ``PaceRule`` decides, or each frame delivered in its own
    turn, as ``DrainRule`` decides."""

    def __init__(self, app, on_result: Optional[Callable] = None,
                 max_frames: Optional[int] = None):
        self.app = app
        self.on_result = on_result
        self.max_frames = max_frames
        self.latencies = []

    def run(self, source: FrameSource) -> int:
        """Pipelined loop; returns the number of frames processed."""
        app, cfg, timer = self.app, self.app.cfg, self.app.timer
        preprocess = app.pipeline.preprocess
        rule, pace = DrainRule(), PaceRule()
        inflight = None   # (t_start, frame id, frame, meta, device outputs, issue s)
        count = 0
        while self.max_frames is None or count < self.max_frames:
            with timer.stage("stream.read", count):
                t_read = t_lead = time.perf_counter()
                if inflight is not None:
                    slept = pace.sleep_s(t_read)
                    if slept:
                        time.sleep(slept)
                        t_lead += slept
                frame = source.read()
                blocked = time.perf_counter() - t_read
            if frame is None:
                break
            t0 = time.perf_counter()
            drain = rule.read(blocked)
            with timer.stage("stream.preprocess", count):
                meta = preprocess(frame, str(count), input_size=cfg.input_size)
            t_issue = time.perf_counter()
            with timer.stage("stream.issue", count):
                out = app.stream_step(meta)
            t_issued = time.perf_counter()
            issued = t_issued - t_issue
            off = issued        # the issue and the readback waits: not host work
            wait = None
            if inflight is not None:
                waited, wait, device, ready = self._finish(*inflight,
                                                           drained=False)
                off += waited
                pace.done(t_issued - t_lead, waited, device, ready, t_issue)
            inflight = (t0, count, frame, meta, out, issued)
            if drain:
                waited, wait, _, _ = self._finish(*inflight, drained=True)
                off += waited
                inflight = None
                pace.start = None       # no frame in flight to pace
            rule.done(time.perf_counter() - t0 - off, wait)
            count += 1
        if inflight is not None:
            self._finish(*inflight, drained=False)
        return count

    def _finish(self, t0, fid, frame, meta, out, issued, drained: bool):
        """The frame's one readback, then composite, latency, deliver.
        Returns the seconds the readback waited; the frame's wait for
        ``DrainRule``: that same wait where the frame drained; where it was
        in flight, its device time less its issue's ``issued`` seconds, the
        part of the step that ran under the issue; 0 for a synchronous
        step; and for ``PaceRule`` the frame's device seconds (None for a
        synchronous step) and the host time its event passed (None where
        it had passed when queried)."""
        app, timer = self.app, self.app.timer
        step = out
        t_query = time.perf_counter()
        with timer.stage("stream.readback", fid):
            out = app.unpack_stream(step)
        waited = getattr(step, "waited_s", 0.0)
        wait, device, ready = 0.0, None, None
        if hasattr(step, "copied"):
            device = step.device_s()
            wait = waited if drained else max(0.0, device - issued)
            ready = t_query + waited if waited else None
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
        return waited, wait, device, ready

    def p50_latency_ms(self) -> float:
        return float(np.percentile(self.latencies, 50)) if self.latencies else 0.0
