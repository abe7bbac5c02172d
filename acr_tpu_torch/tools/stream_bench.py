"""Interactive-path latency: p50/p90 ms per frame over a synthetic stream.

Counterpart of ``tools/stream_bench.py``: the full webcam stack
(preprocess, the stream step's forward, OneEuro, refine and device
render, one readback per frame, the host composite) through
``StreamingLoop`` over ``--frames`` seeded 96 x 128 frames, after three
warm-up frames, on ``checkpoints/wild.npz`` (made where absent). It
prints the latency percentiles with the card's name and power limit.

Usage:
    python -m acr_tpu_torch.tools.stream_bench [--frames 80]
        [--precision fp32] [--quantize none] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

from acr_tpu_torch.tools.dryrun import CKPT, MANO_DIR, _ensure_assets
from acr_tpu_torch.utils.device import card_line, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--precision", default="fp32")
    ap.add_argument("--quantize", default="none")
    ap.add_argument("--model_path", default=CKPT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from acr_tpu_torch.config import Config
    from acr_tpu_torch.pipeline.app import ACRApp
    from acr_tpu_torch.pipeline.streaming import StreamingLoop, SyntheticSource
    dev = resolve_device(args.device)
    _ensure_assets(args.model_path)
    cfg = Config(mano_model_path=MANO_DIR, model_path=args.model_path,
                 model_precision=args.precision, quantize=args.quantize,
                 renderer="tpu", demo_mode="webcam",
                 temporal_optimization=True)
    app = ACRApp(cfg, device=dev)
    # set-up and warm-up outside the measured stream
    StreamingLoop(app, max_frames=3).run(SyntheticSource(3))

    loop = StreamingLoop(app)
    n = loop.run(SyntheticSource(args.frames))
    lat = np.asarray(loop.latencies)       # milliseconds
    print(f"{n} frames  p50={np.percentile(lat, 50):.1f} ms  "
          f"p90={np.percentile(lat, 90):.1f} ms  "
          f"mean={lat.mean():.1f} ms  [{card_line(dev)}]")
    return lat


if __name__ == "__main__":
    main()
