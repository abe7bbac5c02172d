"""Per-op profile of the b1 webcam stream step, on the port.

Counterpart of ``tools/profile_stream.py``: the stream step (forward,
OneEuro, refine, the device render) on the realistic two-hand scene of
``stream_setup.stream_step_setup``, the scaffolding the precision ladder
measures, so the render takes the same kernels here as there: B1
(``raster_binned_kernel``) below 1024 px and B3 (``raster_banded_kernel``)
at ``--render_size 2048``, where the renderer leads. Three warm-up steps,
then ``--iters`` steps under ``torch.profiler`` (CPU and CUDA activity),
read back inside the trace. The Chrome trace goes to ``--trace_dir``;
the table and the category rollup are ``profile_step``'s.

``--reuse`` captures nothing: it reads the newest Chrome trace in
``--trace_dir`` and builds the same rows from its events, the device's
kernels, copies and sets on a card, the operators (with their self time)
on the CPU.

Usage:
    python -m acr_tpu_torch.tools.profile_stream [--render_size 2048]
        [--iters 20] [--precision fp32] [--quantize none] [--top 40]
        [--trace_dir ./profile_stream_trace] [--reuse] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch

from acr_tpu_torch.tools.dryrun import CKPT
from acr_tpu_torch.tools.profile_step import category, op_rows, report
from acr_tpu_torch.utils.device import card_line, resolve_device

# the Chrome trace's categories of the rows: the device's events on a
# card, the operators (record_function ranges among them) on the CPU
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CPU_CATS = ("cpu_op", "user_annotation")


def capture(precision: str, quantize: str, render_size: int, iters: int,
            trace_dir: str, *, device="cuda", model_path: str = CKPT):
    """Profile ``iters`` stream steps after three warm-up steps, forced
    inside the trace; returns (profiler, device) and writes the Chrome
    trace under ``trace_dir``."""
    from torch.profiler import ProfilerActivity, profile
    from acr_tpu_torch.tools.stream_setup import stream_step_setup
    dev = resolve_device(device)
    # the scaffolding the precision ladder measures: same scene, same
    # pre-uploaded frames, same readback
    app, step, _, uploads, force = stream_step_setup(
        precision, quantize, render_size, device=dev, model_path=model_path)
    for image, offsets in uploads(3):             # set-up + warm-up
        out = step({"image": image, "offsets": offsets})
    force(out)

    bufs = uploads(iters)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for image, offsets in bufs:
            out = step({"image": image, "offsets": offsets})
        force(out)                                # force inside the trace
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"profile_stream_{time.strftime('%Y%m%d_%H%M%S')}_"
        f"{os.getpid()}.pt.trace.json"))
    return prof, app.pipeline.device


def newest_trace(trace_dir: str) -> str:
    paths = glob.glob(os.path.join(trace_dir, "*.json"))
    if not paths:
        raise FileNotFoundError(f"no Chrome trace (*.json) in {trace_dir}")
    return max(paths, key=os.path.getmtime)


def _ns(us: float) -> int:
    return round(us * 1000)


def _self_times(events: List[Dict]):
    """(name, self us) of each operator of one thread, nested by their
    intervals in whole nanoseconds as ``key_averages`` nests them: an
    operator's self time is its duration less its children's, and a
    child named as its parent, and its parent's only child, is merged
    into the parent."""
    events = sorted(events, key=lambda e: (_ns(e["ts"]),
                                           -_ns(e["ts"]) - _ns(e["dur"])))
    nodes, stack = [], []
    for e in events:
        start, dur = _ns(e["ts"]), _ns(e["dur"])
        while stack and (start >= stack[-1]["end"]
                         or start + dur > stack[-1]["end"]):
            stack.pop()
        node = {"name": e["name"], "dur": dur, "end": start + dur,
                "children": [], "parent": stack[-1] if stack else None}
        if node["parent"] is not None:
            node["parent"]["children"].append(node)
        nodes.append(node)
        stack.append(node)
    for node in nodes:
        parent = node["parent"]
        if (parent is not None and parent["name"] == node["name"]
                and len(parent["children"]) == 1):
            parent["children"] = node["children"]
            for child in node["children"]:
                child["parent"] = parent
            node["merged"] = True
    return [(n["name"], (n["dur"] - sum(c["dur"] for c in n["children"]))
             / 1000) for n in nodes if not n.get("merged")]


def trace_rows(path: str, device) -> List[Dict]:
    """``profile_step.op_rows``'s rows from a Chrome trace: on a card the
    device's kernels, copies and sets by their durations; on the CPU the
    operators by their self time."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    if torch.device(device).type == "cuda":
        timed = [(e["name"], e["dur"]) for e in events
                 if e.get("cat") in DEVICE_CATS]
    else:
        threads = defaultdict(list)
        for e in events:
            if e.get("cat") in CPU_CATS:
                threads[(e["pid"], e["tid"])].append(e)
        timed = [t for evs in threads.values() for t in _self_times(evs)]
    totals: Dict[str, List[float]] = {}
    for name, us in timed:
        acc = totals.setdefault(name, [0.0, 0])
        acc[0] += us
        acc[1] += 1
    rows = [{"op": name, "category": category(name), "self_us": float(us),
             "occurrences": n} for name, (us, n) in totals.items() if us > 0]
    rows.sort(key=lambda r: -r["self_us"])
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--precision", default="fp32")
    ap.add_argument("--quantize", default="none")
    ap.add_argument("--render_size", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--trace_dir", default="./profile_stream_trace")
    ap.add_argument("--reuse", action="store_true",
                    help="skip capture; analyze the newest trace in trace_dir")
    ap.add_argument("--model_path", default=CKPT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.reuse:
        path = newest_trace(args.trace_dir)
        rows = trace_rows(path, dev)
    else:
        prof, dev = capture(args.precision, args.quantize, args.render_size,
                            args.iters, args.trace_dir, device=dev,
                            model_path=args.model_path)
        path = newest_trace(args.trace_dir)
        rows = op_rows(prof, dev)
    print(f"# trace: {path}")
    print(f"# stream step b1, render {args.render_size} px, "
          f"{args.precision}/{args.quantize} [{card_line(dev)}]")
    print(report(rows, args.iters, args.top, dev))
    return rows


if __name__ == "__main__":
    main()
