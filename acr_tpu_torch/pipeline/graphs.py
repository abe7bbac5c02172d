"""CUDA graphs of the batch-1 step: one per stage and key, replayed per call.

The webcam stream step (and image mode's device step) at batch 1 is some
4,000 launches of small kernels; issued one by one, the host spends about
20 us on each while the card idles. ``StepGraph`` captures one stage's
launches into a CUDA graph once and replays it with one launch per call:

* the first call of a key runs eagerly, so that cuDNN, cuBLAS and the
  allocator settle (and the index tensors of ``models/mano.py`` are
  built); the second captures and replays; every later call replays;
* the inputs are copied into static device tensors that the graph reads:
  host tensors through a pinned buffer with ``non_blocking=True``, device
  tensors device to device;
* inside the graph the outputs are copied into one byte buffer, each at
  an offset aligned as a fresh allocation; after a replay one copy of it
  gives the caller fresh tensors, views of that copy. A returned dict is
  never changed by a later call, as in eager mode;
* the graph runs the eager kernels in the eager order on the eager
  dtypes, so its outputs equal the eager ones bit for bit;
* a capture that raises leaves its key eager for the life of the
  ``StepGraph``, with the reason logged once.

The graph reads every other tensor the stage touches (weights, MANO
assets, faces, the OneEuro state) where it lay at capture, in place.

Where a stage may engage is decided by its owner from what it can
observe: a CUDA device, no mesh, batch 1 and, for the render, a size
below 1024 px (``ACRPipeline.__call__``, ``ACRApp._issue``,
``pipeline.hamer.Regressor.issue``). ``COUNTS``
counts the captures, the replays and the eager steps with their reasons,
beside ``mano_kernel.LAUNCHES`` and ``raster_cuda.LAUNCHES``, which a
replay advances by the kernel launches it holds.
"""

from __future__ import annotations

import collections
import logging
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch

from acr_tpu_torch.ops import mano_kernel
from acr_tpu_torch.viz import raster_cuda

log = logging.getLogger("acr_tpu_torch")

# "<stage>.capture", "<stage>.replay" and "<stage>.eager.<reason>", reason
# one of warmup, cpu, mesh, batch, render_size, capture_failed, since the
# last reset_counts()
COUNTS: Dict[str, int] = collections.Counter()

# the launch counters a replay advances
_LAUNCH_COUNTERS = (mano_kernel.LAUNCHES, raster_cuda.LAUNCHES)

# bytes from one output to the next in the output buffer: the alignment
# of a fresh allocation, as far as a kernel's choice can see it
_ALIGN = 256

Outputs = Dict[str, torch.Tensor]


def reset_counts() -> None:
    COUNTS.clear()


def count_eager(stage: str, reason: str) -> None:
    COUNTS[f"{stage}.eager.{reason}"] += 1


class _Key:
    """One key's static inputs, pinned buffers and, once captured, graph."""

    def __init__(self, inputs: Dict[str, torch.Tensor], device: torch.device):
        self.device = device
        self.static = {n: torch.empty(v.shape, dtype=v.dtype, device=device)
                       for n, v in inputs.items()}
        self.pinned: Dict[str, torch.Tensor] = {}
        self.copied: Optional[torch.cuda.Event] = None
        self.warm = False
        self.failed = False
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.buffer: Optional[torch.Tensor] = None
        self.layout: List[Tuple[str, int, int, torch.dtype, torch.Size]] = []
        self.launches: List[Tuple[Dict[str, int], Dict[str, int]]] = []

    def stage(self, inputs: Dict[str, torch.Tensor]) -> None:
        """Copy ``inputs`` into the static tensors, without a host wait.

        A pinned buffer is rewritten only once the copy out of it has run.
        The stream loop reads frame k-1 back, synchronising the device,
        between issuing frame k and frame k+1, so the event has passed by
        then and nothing waits; an event-based readback will need two
        buffers used in turn."""
        host = any(not v.is_cuda for v in inputs.values())
        if host and self.copied is not None and not self.copied.query():
            self.copied.synchronize()
        for name, value in inputs.items():
            if value.is_cuda:
                self.static[name].copy_(value)
                continue
            buf = self.pinned.get(name)
            if buf is None:
                buf = torch.empty(value.shape, dtype=value.dtype,
                                  pin_memory=True)
                self.pinned[name] = buf
            buf.copy_(value)
            self.static[name].copy_(buf, non_blocking=True)
        if host:
            if self.copied is None:
                self.copied = torch.cuda.Event()
            self.copied.record()

    def capture(self, fn: Callable[[Outputs], Outputs]) -> None:
        """Capture ``fn(static inputs)`` and the copy of its outputs into
        the output buffer. The launch counters are left as they were; the
        launches the capture made are kept for the replays."""
        before = [dict(c) for c in _LAUNCH_COUNTERS]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = fn(self.static)
                layout, end = [], 0
                for name, value in out.items():
                    nbytes = value.numel() * value.element_size()
                    layout.append((name, end, nbytes, value.dtype, value.shape))
                    end += -(-nbytes // _ALIGN) * _ALIGN
                buffer = torch.empty(end, dtype=torch.uint8,
                                     device=self.device)
                for (_, at, nbytes, dtype, shape), value in zip(
                        layout, out.values()):
                    _view(buffer, at, nbytes, dtype, shape).copy_(value)
        finally:
            self.launches = []
            for counter, was in zip(_LAUNCH_COUNTERS, before):
                delta = {k: counter[k] - was.get(k, 0) for k in counter}
                self.launches.append((counter,
                                      {k: d for k, d in delta.items() if d}))
                counter.update(was)
        self.graph, self.buffer, self.layout = graph, buffer, layout

    def replay(self) -> Outputs:
        self.graph.replay()
        for counter, delta in self.launches:
            for k, d in delta.items():
                counter[k] += d
        fresh = self.buffer.clone()
        return {name: _view(fresh, at, nbytes, dtype, shape)
                for name, at, nbytes, dtype, shape in self.layout}


def _view(buffer: torch.Tensor, at: int, nbytes: int, dtype: torch.dtype,
          shape: torch.Size) -> torch.Tensor:
    return buffer[at:at + nbytes].view(dtype).view(shape)


class StepGraph:
    """One stage of the step (``name``: forward, regress, smooth or
    render) on a CUDA device, through a graph per key once it has run
    eagerly once."""

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.device = device
        self._keys: Dict[Hashable, _Key] = {}

    def __call__(self, key: Hashable, fn: Callable[[Outputs], Outputs],
                 inputs: Dict[str, torch.Tensor]) -> Outputs:
        """``fn(inputs on the device)``, a dict of tensors from a dict of
        tensors, eagerly, by capture or by replay. ``key`` names what else
        changes ``fn``'s launches; the inputs' shapes and dtypes join it."""
        full = (key, tuple((n, tuple(v.shape), v.dtype)
                           for n, v in inputs.items()))
        k = self._keys.get(full)
        if k is None:
            k = self._keys[full] = _Key(inputs, self.device)
        with torch.cuda.device(self.device):
            k.stage(inputs)
            if k.graph is None and not k.failed:
                if not k.warm:
                    k.warm = True
                    count_eager(self.name, "warmup")
                    return fn(k.static)
                try:
                    k.capture(fn)
                except Exception as exc:        # any capture error: stay eager
                    k.failed = True
                    log.warning("the %s step's CUDA graph capture failed, so "
                                "it stays eager for key %s: %s: %s", self.name,
                                key, type(exc).__name__, exc)
                else:
                    COUNTS[f"{self.name}.capture"] += 1
            if k.failed:
                count_eager(self.name, "capture_failed")
                return fn(k.static)
            COUNTS[f"{self.name}.replay"] += 1
            return k.replay()
