"""Small helpers the metric files share."""

from __future__ import annotations

import statistics
from typing import List, Optional

from port_bench.harness.trace import kernel_mean_s


def median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None


def percentile(values: List[float], q: float) -> Optional[float]:
    """The q-th percentile of every value, by linear interpolation."""
    if not values:
        return None
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def timer_ms(obs, stage: str, per: int = 1) -> Optional[float]:
    """Mean ms per call of one ``ACRApp.timer`` stage over the window,
    divided by ``per``."""
    t = obs.timer.get(stage)
    if not t or not t["count"]:
        return None
    return t["sum_ms"] / t["count"] / per


def roofline_pct(obs, kernel: str, bound_key: str) -> Optional[float]:
    """The work's least time over the kernel's mean device time."""
    if obs.trace is None or bound_key not in obs.work:
        return None
    t = kernel_mean_s(obs.trace, kernel)
    return None if not t else 100.0 * obs.work[bound_key] / t


def forward_device_ms(obs) -> Optional[float]:
    """Device ms per frame of the kernels launched inside the calls into
    ``ACRPipeline``."""
    if obs.trace is None:
        return None
    a = obs.trace["annotations"].get("port_bench.forward")
    if not a or not a["count"] or not a["device_s"]:
        return None
    return 1e3 * a["device_s"] / (a["count"] * obs.batch)


def idle_pct(obs) -> Optional[float]:
    if obs.trace is None or not obs.trace["busy_s"]:
        return None
    return 100.0 * (1.0 - obs.trace["busy_s"] / obs.trace["window_s"])


def step_mfu_pct(obs, rate: float) -> Optional[float]:
    """The network's FLOPs per frame times frames per second over the
    card's peak in the configuration's precision."""
    if obs.peaks is None or not rate:
        return None
    return 100.0 * obs.work["flops_per_frame"] * rate / obs.peaks[obs.precision]
