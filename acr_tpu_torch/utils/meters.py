"""Running metrics and per-stage latency timing (``AverageMeter``,
``AverageMeterDict`` and ``StageTimer`` copied from
acr_tpu/utils/meters.py: the JAX package cannot be imported where the
port runs), and ``SpanTimer``, the port's stages as spans.

Per-stage wall-clock (preprocess / device step / render / encode) and
end-to-end frame latency, reported on demand.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple

import torch


class AverageMeter:
    """Running average / sum / count of a scalar series."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class AverageMeterDict:
    """Keyed collection of AverageMeters."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = defaultdict(AverageMeter)

    def update(self, values: Dict[str, float], n: int = 1):
        for key, val in values.items():
            self.meters[key].update(val, n)

    def avg(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def __getitem__(self, key: str) -> AverageMeter:
        return self.meters[key]


class StageTimer:
    """Accumulates wall-clock per named stage; context-manager based.

    >>> timer = StageTimer()
    >>> with timer.stage("preprocess"): ...
    >>> timer.report()
    {'preprocess': {'avg_ms': ..., 'count': ...}}
    """

    def __init__(self):
        self.meters = AverageMeterDict()

    class _Ctx:
        def __init__(self, timer: "StageTimer", name: str):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            dt = (time.perf_counter() - self.t0) * 1000.0
            self.timer.meters.update({self.name: dt})
            return False

    def stage(self, name: str) -> "StageTimer._Ctx":
        return StageTimer._Ctx(self, name)

    def add(self, name: str, ms: float):
        """Record an externally-timed duration (e.g. measured on a
        prefetch thread) under ``name``."""
        self.meters.update({name: ms})

    def report(self) -> Dict[str, Dict[str, float]]:
        return {name: {"avg_ms": m.avg, "last_ms": m.val, "count": m.count}
                for name, m in self.meters.meters.items()}


# (name, parent name, frame id, t_start, t_end), times on time.perf_counter
Span = Tuple[str, Optional[str], object, float, float]


class SpanTimer(StageTimer):
    """A ``StageTimer`` whose stages are also spans while ``recording`` is on.

    Off (the default), ``stage`` is ``StageTimer.stage``: two clock reads
    and an average update. On, each stage also appends a record
    ``(name, parent, frame, t_start, t_end)`` (``time.perf_counter``
    seconds): ``parent`` is the innermost open stage, ``frame`` the id
    given, else the parent's, so the spans of one frame share its id. And
    it runs inside ``torch.profiler.record_function("acr." + name)``: under
    a running ``torch.profiler`` the span is a ``user_annotation`` of the
    trace, on the clock of the kernels it launched.

    The records stay in memory, the newest ``MAX_RECORDS``, until
    ``clear()``. Stages open and close on one thread.
    """

    MAX_RECORDS = 1 << 16

    def __init__(self):
        super().__init__()
        self.recording = False
        self._records: deque = deque(maxlen=self.MAX_RECORDS)
        self._open: List[Tuple[str, object]] = []   # innermost last

    class _Span:
        def __init__(self, timer: "SpanTimer", name: str, frame):
            self.timer, self.name, self.frame = timer, name, frame

        def __enter__(self):
            open_ = self.timer._open
            self.parent = open_[-1][0] if open_ else None
            if self.frame is None and open_:
                self.frame = open_[-1][1]
            open_.append((self.name, self.frame))
            self.note = torch.profiler.record_function("acr." + self.name)
            self.note.__enter__()
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            t1 = time.perf_counter()
            self.note.__exit__(*exc)
            timer = self.timer
            timer._open.pop()
            timer.meters.update({self.name: (t1 - self.t0) * 1000.0})
            timer._records.append((self.name, self.parent, self.frame,
                                   self.t0, t1))
            return False

    def stage(self, name: str, frame=None):
        if not self.recording:
            return super().stage(name)
        return SpanTimer._Span(self, name, frame)

    def add_span(self, name: str, t_start: float, t_end: float, frame=None):
        """A span the caller timed, such as one that outlives a loop turn:
        averaged as ``add`` does and, while recording, kept with no parent
        (and no trace annotation)."""
        self.add(name, (t_end - t_start) * 1000.0)
        if self.recording:
            self._records.append((name, None, frame, t_start, t_end))

    def spans(self) -> List[Span]:
        """The records kept, oldest first."""
        return list(self._records)

    def clear(self):
        self._records.clear()
