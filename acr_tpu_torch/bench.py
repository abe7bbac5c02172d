"""Benchmark: two-hand 512 px inference throughput on one card.

Counterpart of ``bench.py``; run as ``python -m acr_tpu_torch.bench``.
It makes JAX's measurements in JAX's order, under the same environment
variables, and prints ONE JSON line with JAX's ``metric``, ``value``,
``unit`` and ``extra``, without ``vs_baseline`` (a ratio to a TPU
figure) and with ``card``: the card's ``nvidia-smi`` name and power
limit, or ``cpu``.

The headline is ``__graft_entry__._build``'s forward chain (backbone,
heads, parser, MANO, projection, translation solve) at bf16 on a
resident batch of 8 (``dryrun._build``; 8 hands per side take the fused
MANO kernel), with its roofline. ``extra`` holds the fp32 b1 median of
``ACR_BENCH_REPS`` runs and its spread, the b1 webcam stream step
(forward, OneEuro, MANO refine, device render;
``tools.stream_setup.measure_stream_b1``) at fp32, bf16, bf16+int8 and
render 2048, the ``StreamingLoop`` frame latency at p50/p90, and the
bf16+int8 forward at b16. A variant that raises leaves JAX's
``"skipped: <Type>"`` marker in the line and its traceback on stderr.

Environment: ``ACR_BENCH_ITERS`` (30), ``ACR_BENCH_REPS`` (5);
``ACR_BENCH_PRECISION``, ``ACR_BENCH_BATCH`` and ``ACR_BENCH_QUANT``
measure one forward config instead; ``ACR_BENCH_DP=n`` the forward over
n replicas at ``ACR_BENCH_SIZE`` px (512). ``ACR_BENCH_PLATFORM=cpu``
runs on the CPU (the plain versions of the kernels, and ``n`` CPU
replicas for DP); anything else means the card, and the run raises
without one. ``ACR_COMPILE_CACHE`` has no counterpart: nothing is
compiled ahead of the run (the kernels' build is ``ops.cuda_lib``'s).

Timing is JAX's: each timed region ends with a readback of one small
output, which forces the whole chain, and the time of one readback of a
finished result is subtracted; both rates are reported. JAX needed that
for a relayed TPU transport; on the card the readback is a sync and a
copy of a few bytes, so the correction is small.

The roofline replaces XLA's cost analysis. The FLOPs are
``torch.utils.flop_counter.FlopCounterMode``'s count of one call of the
same forward on the same inputs; the bytes are every aten op's tensor
inputs read once and outputs written once (``ByteCounter``), the eager
counterpart of XLA's per-op "bytes accessed". The fused MANO kernel runs
outside aten, so its work is added from its shape
(``ops.mano_kernel.fused_work``). ``mfu_pct`` is the achieved FLOP/s
over the card's dense peak at the step's precision, from
``utils.device.PEAKS``.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback
from typing import Dict, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from acr_tpu_torch.ops import mano_kernel
from acr_tpu_torch.tools import dryrun, stream_setup
from acr_tpu_torch.tools.dryrun import CKPT
from acr_tpu_torch.tools.stream_setup import stream_step_setup  # noqa: F401
from acr_tpu_torch.utils.device import card_line, card_peaks, resolve_device

SIZE = 512                      # the headline's input size
# aten ops that allocate and write nothing
_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.empty_like,
                torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
                torch.ops.aten.new_empty_strided}


class ByteCounter(TorchDispatchMode):
    """Sums the bytes each aten op moves: every tensor argument read once
    and every returned tensor written once (an in-place op both reads and
    writes its operand). An op that only makes a view or an alias of its
    input, and an allocation, moves nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.overloadpacket not in _ALLOCATIONS:
            self.bytes += sum(t.numel() * t.element_size() for t in
                              tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def step_work(fn, inputs, hands: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one call ``fn(*inputs)``: FlopCounterMode's count
    and ``ByteCounter``'s, plus the fused MANO kernel's work for each of
    its launches in the call, at ``hands`` hands per launch (the forward
    runs each side's batch in one launch)."""
    from torch.utils.flop_counter import FlopCounterMode
    launched = mano_kernel.LAUNCHES["mano_fused"]
    with FlopCounterMode(display=False) as flops, ByteCounter() as moved:
        fn(*inputs)
    launched = mano_kernel.LAUNCHES["mano_fused"] - launched
    k_bytes, k_flops = mano_kernel.fused_work(hands)
    return (flops.get_total_flops() + launched * k_flops,
            moved.bytes + launched * k_bytes)


def _roofline(fn, inputs, fps: float, batch: int, precision: str,
              device) -> Dict:
    """JAX's roofline keys for ``fn`` at ``fps`` frames/s (``mfu_pct`` for
    JAX's ``mxu_util_pct``); on the CPU the two counts only."""
    flops, n_bytes = step_work(fn, inputs, batch)
    r = {"gflops_per_step": round(flops / 1e9, 1),
         "hbm_gb_per_step": round(n_bytes / 1e9, 2)}
    if torch.device(device).type == "cpu":
        return r
    peaks = card_peaks(device)
    steps_per_s = fps / batch
    flops_s, bytes_s = flops * steps_per_s, n_bytes * steps_per_s
    r.update({
        "achieved_tflops": round(flops_s / 1e12, 1),
        "mfu_pct": round(100 * flops_s / peaks[precision], 1),
        "apparent_hbm_gbps": round(bytes_s / 1e9, 0),
        "hbm_bound": bool(bytes_s / peaks["bytes_s"]
                          > flops_s / peaks[precision]),
    })
    return r


def _measure(precision: str, batch: int, iters: int, quantize: str = "none",
             roofline: bool = False, *, device="cuda",
             model_path: str = CKPT) -> Dict:
    """The forward chain at ``precision`` / ``quantize`` on a resident
    seeded uint8 batch of ``batch`` frames at 512 px (JAX's
    ``RandomState(0)`` frames, uploaded once): 1 + 3 warm-up calls, each
    forced by a readback of ``cam_trans``'s sum; one readback of a
    finished result timed; then ``iters`` chained calls ended by one
    readback. Returns ``fps`` (less the readback), ``fps_uncorrected``,
    ``readback_ms`` and, with ``roofline``, ``_roofline``'s keys. On the
    card the readback is a sync and a copy of 4 bytes, so ``fps`` and
    ``fps_uncorrected`` differ little (JAX's relayed transport made it a
    round trip of tens of ms)."""
    fn, pipe = dryrun._build(SIZE, precision, quantize, device=device,
                             model_path=model_path)
    dev = pipe.device
    image, offsets = dryrun.example_inputs(batch, SIZE, dev)

    def force(out):
        return float(out["cam_trans"].sum())

    for _ in range(4):                      # set-up + warm-up
        force(fn(image, offsets))

    out = fn(image, offsets)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    time.sleep(0.05)
    t = time.perf_counter()
    force(out)                              # a finished result
    readback_s = time.perf_counter() - t

    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(image, offsets)
    force(out)                              # the timed region ends here
    dt_raw = time.perf_counter() - t0
    dt = max(dt_raw - readback_s, 1e-9)
    r = {
        "fps": round(iters * batch / dt, 2),
        "fps_uncorrected": round(iters * batch / dt_raw, 2),
        "readback_ms": round(readback_s * 1e3, 1),
    }
    if roofline:
        r["roofline"] = _roofline(fn, (image, offsets), r["fps"], batch,
                                  precision, dev)
    return r


def _measure_stream_loop(n_frames: int, *, device="cuda",
                         model_path: str = CKPT) -> Dict:
    """``StreamingLoop`` frame latency on the realistic scene at fp32
    (preprocess, the fused step, one readback, the composite, per frame)
    over ``n_frames`` synthetic 640x480 frames, after one warm frame."""
    from acr_tpu_torch.pipeline.streaming import StreamingLoop, SyntheticSource
    app = stream_setup.build_stream_app("fp32", device=device,
                                        model_path=model_path)
    StreamingLoop(app).run(SyntheticSource(1, height=480, width=640))
    loop = StreamingLoop(app)
    processed = loop.run(SyntheticSource(n_frames, height=480, width=640))
    lat = np.sort(np.asarray(loop.latencies))
    return {
        "stream_loop_p50_ms": round(float(np.percentile(lat, 50)), 1),
        "stream_loop_p90_ms": round(float(np.percentile(lat, 90)), 1),
        "stream_loop_frames": int(processed),
    }


def _measure_dp(dp: int, precision: str, batch: int, iters: int, *,
                device="cuda", model_path: str = CKPT) -> Dict:
    """The forward over ``dp`` replicas (``ACRPipeline`` with
    ``data_parallel=dp``: weights replicated, the batch sharded) at
    ``ACR_BENCH_SIZE`` px, the frames uploaded by every call as in JAX:
    1 + 2 warm-up calls, then ``iters`` calls ended by one readback. The
    replicas are ``dp`` distinct cards, or the CPU ``dp`` times; with
    fewer cards it raises, so a one-card figure never reads as a
    several-card one."""
    from acr_tpu_torch.pipeline.infer import ACRPipeline
    dev = resolve_device(device)
    if dev.type == "cpu":
        devices = ["cpu"] * dp
    else:
        have = torch.cuda.device_count()
        if have < dp:
            raise RuntimeError(
                f"ACR_BENCH_DP={dp} needs {dp} cards, have {have} (set "
                f"ACR_BENCH_PLATFORM=cpu to run the plumbing on {dp} CPU "
                "replicas)")
        devices = [f"cuda:{i}" for i in range(dp)]
    size = int(os.environ.get("ACR_BENCH_SIZE", "512"))
    cfg = dryrun._config(size, precision, model_path=model_path,
                         data_parallel=dp)
    pipe = ACRPipeline(cfg, devices=devices)
    image, offsets = (t.numpy() for t in dryrun.example_inputs(batch, size))

    def force(out):
        return float(out["cam_trans"].sum())

    for _ in range(3):                      # set-up + warm-up
        force(pipe(image, offsets))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = pipe(image, offsets)
    force(out)
    dt = time.perf_counter() - t0
    return {"fps": round(iters * batch / dt, 2), "devices": dp,
            "batch": batch, "input_size": size}


def _skipped(key: str, e: Exception) -> str:
    print(f"# {key} skipped:", file=sys.stderr)
    traceback.print_exception(e, file=sys.stderr)
    return f"skipped: {type(e).__name__}"


def main() -> Dict:
    """Measure, print the JSON line, and return it."""
    device = resolve_device(
        "cpu" if os.environ.get("ACR_BENCH_PLATFORM") == "cpu" else "cuda")
    on = dict(device=device)
    dryrun._ensure_assets()

    iters = int(os.environ.get("ACR_BENCH_ITERS", "30"))
    precision = os.environ.get("ACR_BENCH_PRECISION")
    batch = os.environ.get("ACR_BENCH_BATCH")
    quantize = os.environ.get("ACR_BENCH_QUANT", "none")
    dp = int(os.environ.get("ACR_BENCH_DP", "0") or 0)
    if dp > 1:
        precision = precision or "bf16"
        batch = int(batch or 8 * dp)
        r = _measure_dp(dp, precision, batch, iters, **on)
        metric = (f"two_hand_{r['input_size']}px_inference_fps_"
                  f"dp{dp}_b{batch}_{precision}")
        fps, extra = r["fps"], r
    elif precision or batch or quantize != "none":
        precision = precision or "bf16"
        batch = int(batch or 8)
        r = _measure(precision, batch, iters, quantize=quantize, **on)
        extra = {"readback_ms": r["readback_ms"],
                 "fps_uncorrected": r["fps_uncorrected"]}
        metric = f"two_hand_512px_inference_fps_b{batch}_{precision}"
        if quantize != "none":
            metric += f"_{quantize}"
        fps = r["fps"]
    else:
        reps = int(os.environ.get("ACR_BENCH_REPS", "5"))
        hot = _measure("bf16", 8, iters, roofline=True, **on)
        demo_fps = sorted(_measure("fp32", 1, iters, **on)["fps"]
                          for _ in range(reps))
        metric = "two_hand_512px_inference_fps_b8_bf16"
        fps = hot["fps"]
        extra = {
            "fp32_b1_fps": round(float(np.median(demo_fps)), 2),
            "fp32_b1_fps_spread": [demo_fps[0], demo_fps[-1]],
            "bf16_b8_fps_uncorrected": hot["fps_uncorrected"],
            "readback_ms": hot["readback_ms"],
            "roofline": hot["roofline"],
        }
        stream_variants = [
            ("stream_step_ms_b1", dict()),
            ("stream_step_ms_b1_bf16", dict(precision="bf16", tag="_bf16")),
            ("stream_step_ms_b1_int8", dict(precision="bf16",
                                            quantize="int8", tag="_int8")),
            ("stream_step_ms_b1_2048px", dict(render_size=2048,
                                              tag="_2048px", min_iters=60)),
        ]
        for key, kwargs in stream_variants:
            try:
                r = stream_setup.measure_stream_b1(iters, reps, **kwargs,
                                                   **on)
                r.pop("card")
                extra.update(r)
            except Exception as e:
                extra[key] = _skipped(key, e)
        try:
            extra.update(_measure_stream_loop(max(iters, 20), **on))
        except Exception as e:
            extra["stream_loop_p50_ms"] = _skipped("stream_loop_p50_ms", e)
        try:
            q = _measure("bf16", 16, iters, quantize="int8", **on)
            extra["int8_b16_fps"] = q["fps"]
        except Exception as e:
            extra["int8_b16_fps"] = _skipped("int8_b16_fps", e)

    line = {"metric": metric, "value": fps, "unit": "frames/sec",
            "extra": extra, "card": card_line(device)}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
