"""Running metrics and per-stage latency timing (copied from
acr_tpu/utils/meters.py: the JAX package cannot be imported where the
port runs).

Per-stage wall-clock (preprocess / device step / render / encode) and
end-to-end frame latency, reported on demand.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, Optional


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
