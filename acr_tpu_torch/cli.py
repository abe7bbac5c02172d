"""CLI entry point: ``python -m acr_tpu_torch.cli --demo_mode image --inputs img.jpg --output_dir out/``.

The flags of ``acr_tpu.cli`` (same ``Config``); ``--device`` picks the
torch device (default ``cuda`` when a card is present, else ``cpu``).
Option values the port does not run yet raise NotImplementedError.
"""

from __future__ import annotations

import logging
import sys


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    import torch
    from acr_tpu_torch.config import parse_args
    from acr_tpu_torch.pipeline.app import ACRApp
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    cfg = parse_args(argv)
    logging.info("config: %s (device %s)", cfg, device)
    return ACRApp(cfg, device=device).run()


if __name__ == "__main__":
    main()
