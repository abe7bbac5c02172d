"""The b1 stream step's precision ladder: fp32, bf16, int8 and 2048 px.

Counterpart of ``tools/precision_ladder.py``: ``stream_setup.
measure_stream_b1`` (the realistic scene, chained steps ended by one
readback) for fp32, bf16 and bf16 + int8 at render 512, and with
``--with_2048`` fp32 at render 2048 with at least 60 chained steps, as
JAX's ladder takes them. Each variant goes to standard error as it
finishes; one JSON line goes to standard output, with the device and the
card's name and power limit.

Usage:
    python -m acr_tpu_torch.tools.precision_ladder [--iters 30]
        [--reps 15] [--with_2048] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

from acr_tpu_torch.tools import stream_setup
from acr_tpu_torch.tools.dryrun import CKPT, _ensure_assets
from acr_tpu_torch.utils.device import card_line, resolve_device


def variants(with_2048: bool):
    """(name, measure_stream_b1 keywords), JAX's list."""
    out = [
        ("fp32", dict()),
        ("bf16", dict(precision="bf16", tag="_bf16")),
        ("int8", dict(precision="bf16", quantize="int8", tag="_int8")),
    ]
    if with_2048:
        # JAX measured a queue-fill transient at 30 chained 2048 px steps
        # and floors that variant at 60 for the sustained rate
        out.append(("2048px", dict(render_size=2048, tag="_2048px",
                                   min_iters=60)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--with_2048", action="store_true")
    ap.add_argument("--model_path", default=CKPT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    _ensure_assets(args.model_path)
    out = {"iters": args.iters, "reps": args.reps, "device": dev.type,
           "card": card_line(dev)}
    for name, kwargs in variants(args.with_2048):
        r = stream_setup.measure_stream_b1(
            args.iters, args.reps, device=dev, model_path=args.model_path,
            **kwargs)
        out[name] = r
        print(f"# {name}: {r}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
