"""CLI entry point: ``python -m acr_tpu_torch.cli --demo_mode image|folder|video|webcam ...``.

The flags of ``acr_tpu.cli`` (same ``Config``), plus ``--device``: the
torch device, ``cuda`` by default. Without a CUDA card the CLI raises;
the plain PyTorch versions run on the CPU only with ``--device cpu``.
Option values the port does not run yet raise NotImplementedError.
"""

from __future__ import annotations

import logging
import sys


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    from acr_tpu_torch.config import parse_args
    from acr_tpu_torch.pipeline.app import ACRApp
    from acr_tpu_torch.utils.device import resolve_device
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    resolve_device(device)          # no card: raise before parsing/loading
    cfg = parse_args(argv)
    logging.info("config: %s (device %s)", cfg, device)
    return ACRApp(cfg, device=device).run()


if __name__ == "__main__":
    main()
