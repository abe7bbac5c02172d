"""Per-op profile of the end-to-end inference step, on the port.

Counterpart of ``tools/profile_step.py``: a ``torch.profiler`` trace of
the forward step (``forward_fn`` at 512 px, as ``tools.dryrun._build``
builds it) at ``--batch`` / ``--precision``, then the top ops by self
time, the rows of the port's own kernels (wherever they rank), and a
rollup by category in place of xprof's framework_op_stats: conv/GEMM,
the port's kernels, elementwise, copies (cuDNN's layout transposes
among them), other. A PyTorch kernel's row is named by its template and
the functor or function it runs (``elementwise_kernel[MulFunctor]``):
their full names run to hundreds of characters, alike in the first 90.

On a card the rows are the device's (the kernels, copies and sets, by
``self_device_time_total``); on the CPU (``--device cpu``) they are the
operators' self CPU time. The Chrome trace is written to ``--trace_dir``.

Usage:
    python -m acr_tpu_torch.tools.profile_step [--precision bf16]
        [--batch 8] [--iters 20] [--top 30] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import re
import time
from typing import Dict, List, Tuple

import torch

from acr_tpu_torch.tools.dryrun import CKPT

# the port's hand-written kernels (csrc/*.cu)
PORT_KERNELS = ("mano_split_kernel", "raster_flat_kernel",
                "raster_binned_kernel", "raster_banded_kernel")
# cuDNN's layout transposes around its NHWC convolutions
LAYOUT = ("nchwtonhwc", "nhwctonchw", "addpadding")
CONV_GEMM = ("conv", "gemm", "cudnn", "cutlass", "xmma", "sm90", "mm",
             "matmul", "linear", "addmm", "bmm", "wgrad", "dgrad", "fprop")
COPIES = ("copy", "memcpy", "memset", "contiguous", "cat", "stack",
          "pad", "clone", "index", "gather", "scatter", "transpose",
          "permute")
ELEMENTWISE = ("elementwise", "vectorized", "reduce", "add", "mul", "sub",
               "div", "relu", "sigmoid", "exp", "clamp", "where", "max",
               "min", "sum", "mean", "norm", "sqrt", "pow", "softmax")


_NATIVE = re.compile(r"void at::native::(?:[\w()]+\s*::)*?(\w+)<")
_FUNCTOR = re.compile(r"(\w*Functor\w*)<")
_IMPL = re.compile(r"(\w+)\(at::TensorIteratorBase")


def label(name: str) -> str:
    """The row's name: for a kernel of PyTorch's own (``at::native``) its
    template and the functor it applies, or the function whose lambda it
    runs (``elementwise_kernel[MulFunctor]``,
    ``vectorized_elementwise_kernel[launch_clamp_scalar]``); any other
    name as it is."""
    kernel = _NATIVE.match(name)
    hits = _FUNCTOR.findall(name) or _IMPL.findall(name)
    if kernel and hits:
        return f"{kernel.group(1)}[{hits[-1]}]"
    return name


def category(name: str) -> str:
    """The rollup's category of an op or kernel name."""
    low = label(name).lower()
    for cat, keys in (("port kernels", PORT_KERNELS), ("copies", LAYOUT),
                      ("conv/GEMM", CONV_GEMM), ("copies", COPIES),
                      ("elementwise", ELEMENTWISE)):
        if any(k in low for k in keys):
            return cat
    return "other"


def capture(precision: str, batch: int, iters: int, trace_dir: str,
            device="cuda", model_path: str = CKPT,
            input_size: int = 512):
    """Profile ``iters`` forward steps after one warm-up; returns
    (profiler, device) and writes the Chrome trace under ``trace_dir``."""
    from torch.profiler import ProfilerActivity, profile
    from acr_tpu_torch.tools.dryrun import _build, _ensure_assets, example_inputs
    from acr_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    _ensure_assets(model_path)
    fn, pipe = _build(input_size, precision=precision,
                         quantize=os.environ.get("ACR_BENCH_QUANT", "none"),
                         device=dev, model_path=model_path)
    image, offsets = example_inputs(batch, input_size, pipe.device)

    def sync():
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)

    fn(image, offsets)                               # cuDNN set-up + drain
    sync()
    activities = [ProfilerActivity.CPU]
    if pipe.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(iters):
            out = fn(image, offsets)
        float(out["cam_trans"].sum())                # force inside trace
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"profile_step_{time.strftime('%Y%m%d_%H%M%S')}_"
        f"{os.getpid()}.pt.trace.json"))
    return prof, pipe.device


def op_rows(prof, device: torch.device) -> List[Dict]:
    """The rows of the table: on a card the device events (kernels,
    copies, sets) by their self device time; on the CPU the operators
    by their self CPU time. Each {op, category, self_us, occurrences}."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if device.type == "cuda":
            if e.device_type == DeviceType.CPU:
                continue
            us = e.self_device_time_total
        else:
            us = e.self_cpu_time_total
        if us <= 0:
            continue
        rows.append({"op": e.key, "category": category(e.key),
                     "self_us": float(us), "occurrences": int(e.count)})
    rows.sort(key=lambda r: -r["self_us"])
    return rows


def rollup(rows: List[Dict]) -> List[Tuple[str, float]]:
    """(category, self us) summed over the rows, largest first."""
    cats: Dict[str, float] = {}
    for r in rows:
        cats[r["category"]] = cats.get(r["category"], 0.0) + r["self_us"]
    return sorted(cats.items(), key=lambda kv: -kv[1])


def report(rows: List[Dict], iters: int, top: int, device) -> str:
    """The printed table: total, top ops, then the rollup."""
    clock = "device" if torch.device(device).type == "cuda" else "CPU"
    if not rows:
        raise RuntimeError(f"the trace holds no {clock} time")
    total = sum(r["self_us"] for r in rows)
    lines = [f"# total self {clock} time: {total/1e3:.2f} ms over {iters} "
             f"iters ({total/1e3/iters:.3f} ms/iter)",
             f"{'self_ms':>9} {'%':>5} {'n':>5}  op (category)"]
    for r in rows[:top]:
        lines.append(f"{r['self_us']/1e3:9.2f} {100*r['self_us']/total:5.1f} "
                     f"{r['occurrences']:5d}  {label(r['op'])[:90]} "
                     f"({r['category']})")
    own = [r for r in rows if r["category"] == "port kernels"]
    if own:
        lines.append("\n# the port's kernels")
        lines += [f"{r['self_us']/1e3:9.3f} {100*r['self_us']/total:5.1f} "
                  f"{r['occurrences']:5d}  {label(r['op'])[:90]}" for r in own]
    lines.append("\n# by category")
    for c, us in rollup(rows):
        lines.append(f"{us/1e3:9.2f} {100*us/total:5.1f}  {c}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--trace_dir", default="./profile_step_trace")
    ap.add_argument("--input_size", type=int, default=512)
    ap.add_argument("--model_path", default=CKPT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    prof, device = capture(args.precision, args.batch, args.iters,
                           args.trace_dir, args.device, args.model_path,
                           args.input_size)
    rows = op_rows(prof, device)
    print(report(rows, args.iters, args.top, device))
    return rows


if __name__ == "__main__":
    main()
