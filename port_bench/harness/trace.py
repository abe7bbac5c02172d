"""The traced sub-window and its reduction.

``Tracer`` runs ``torch.profiler`` (CPU and CUDA activity) over the
last stretch of the measured window: it starts at ``start`` seconds on
the host clock (the driver calls ``poll`` between frames) and stops once
the window has closed, so that the profiler's own stop and export fall
outside it. ``reduce``
reads the exported Chrome trace: the device's busy time (the union of
kernels, copies and sets), the time by kernel name, the device time of
the kernels launched inside each of the harness's annotations
(``port_bench.*``), and the longest device idle gaps named by what the
host was doing then (the innermost annotation, else the innermost torch
operation, else "python").
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    def __init__(self, start: float):
        self.start = start
        self.prof = None
        self.t_on = self.t_off = None
        self.summary: Optional[Dict] = None

    def warm(self, fn) -> None:
        """Run ``fn`` once under a throw-away profile, so that CUPTI's
        set-up falls outside the window."""
        import torch
        with torch.profiler.profile(activities=_activities()):
            fn()

    def poll(self, now: float) -> None:
        import torch
        if self.prof is None and self.t_on is None and now >= self.start:
            self.prof = torch.profiler.profile(activities=_activities())
            self.prof.start()
            self.t_on = time.perf_counter()

    def finish(self) -> None:
        """Stop the profile (if it runs) and reduce it."""
        if self.prof is None or self.t_off is not None:
            return
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t_off = time.perf_counter()
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        self.summary = reduce(events, self.t_off - self.t_on)


def _activities():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events: List[Dict], window_s: float) -> Dict:
    """Chrome trace events (times in microseconds) -> the summary."""
    dev, launches, notes, ops = [], {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat == "cuda_runtime" or cat == "cuda_driver":
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat == "user_annotation" and e["name"].startswith("port_bench."):
            notes.append((ts, ts + dur, e["name"]))
        elif cat == "cpu_op":
            ops.append((ts, ts + dur, e["name"]))
    by_name = defaultdict(lambda: [0, 0.0])
    for e in dev:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += float(e.get("dur", 0)) * 1e-6
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    # device time of the kernels each annotation launched
    notes.sort()
    starts = [n[0] for n in notes]
    note_dev = defaultdict(float)
    note_count = defaultdict(int)
    for s, e, name in notes:
        note_count[name] += 1
    for e in dev:
        t = launches.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        i = bisect.bisect_right(starts, t)
        # the innermost annotation that holds the launch
        for s, end, name in reversed(notes[max(0, i - 8):i]):
            if s <= t <= end:
                note_dev[name] += float(e.get("dur", 0)) * 1e-6
                break
    gaps = []
    for (s0, e0), (s1, _) in zip(busy, busy[1:]):
        gaps.append((s1 - e0, (e0 + s1) / 2))
    gaps.sort(reverse=True)
    op_starts = sorted(ops)
    named = []
    for length, mid in gaps[:10]:
        named.append([_host_at(mid, notes, op_starts), length * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"busy_s": busy_s, "window_s": window_s,
            "kernels": {k: {"count": v[0], "seconds": v[1]}
                        for k, v in by_name.items()},
            "device_ops": [[k, v[1]] for k, v in top[:10]],
            "idle_gaps": named,
            "annotations": {k: {"count": note_count[k],
                                "device_s": note_dev.get(k, 0.0)}
                            for k in note_count}}


def _host_at(t: float, notes, ops) -> str:
    inner = [n for n in notes if n[0] <= t <= n[1]]
    if inner:
        return min(inner, key=lambda n: n[1] - n[0])[2]
    inner = [o for o in ops if o[0] <= t <= o[1]]
    if inner:
        return min(inner, key=lambda o: o[1] - o[0])[2]
    return "python"


def kernel_mean_s(summary: Dict, part: str) -> Optional[float]:
    """Mean device seconds per launch of the kernels whose name holds
    ``part``; None when the trace has none."""
    hits = [v for k, v in summary["kernels"].items() if part in k]
    n = sum(v["count"] for v in hits)
    return sum(v["seconds"] for v in hits) / n if n else None
