"""CLI entry point: ``python -m acr_tpu_torch.cli --demo_mode image|folder|video|webcam ...``.

The flags of ``acr_tpu.cli`` (same ``Config``), plus ``--device``: the
torch device, ``cuda`` by default. Without a CUDA card the CLI raises;
the plain PyTorch versions run on the CPU only with ``--device cpu``.
As in JAX, the merged config is written to ``active_configs/`` for the
length of the run (``utils.session``) and ``--profile_dir`` traces the
run (``utils.profiling``).
"""

from __future__ import annotations

import logging
import sys


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    from acr_tpu_torch.config import parse_args
    from acr_tpu_torch.pipeline.app import ACRApp
    from acr_tpu_torch.utils.device import resolve_device
    from acr_tpu_torch.utils.profiling import profile_trace
    from acr_tpu_torch.utils.session import ConfigSession
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    resolve_device(device)          # no card: raise before parsing/loading
    cfg = parse_args(argv)
    logging.info("config: %s (device %s)", cfg, device)
    with ConfigSession(cfg):
        app = ACRApp(cfg, device=device)
        with profile_trace(cfg.profile_dir, app.pipeline.device):
            return app.run()


if __name__ == "__main__":
    main()
