"""``--profile_dir``: a ``torch.profiler`` trace of the run.

Counterpart of ``acr_tpu/utils/profiling.py`` (a ``jax.profiler`` trace
there; the reference's ``--track_memory_usage`` flag is dead code,
acr/config.py:181). The trace is one Chrome-trace JSON file, readable in
Perfetto or ``chrome://tracing``: host operators, the app's ``acr.*``
spans (``utils.meters.SpanTimer``), and on a card the CUDA kernels with
their device times.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def profile_trace(profile_dir: Optional[str], device="cuda", timer=None):
    """Trace the enclosed block into ``<profile_dir>/acr_tpu_torch_<time>_
    <pid>.pt.trace.json`` when ``profile_dir`` is set: CPU activity, and
    CUDA activity when ``device`` is a card; ``timer`` (a ``SpanTimer``)
    records for the block, so its stages land in the trace. A no-op when
    unset."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"acr_tpu_torch_"
                        f"{time.strftime('%Y-%m-%d_%H_%M_%S')}_"
                        f"{os.getpid()}.pt.trace.json")
    with profile(activities=activities) as prof:
        if timer is None:
            yield
        else:
            recording, timer.recording = timer.recording, True
            try:
                yield
            finally:
                timer.recording = recording
    prof.export_chrome_trace(path)
