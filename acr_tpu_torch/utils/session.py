"""Session config dump: the merged config is written to a timestamped
YAML for the lifetime of the run and removed on exit (the reference's
ConfigContext behaviour, acr/config.py:225-267 — minus the exec() and
the import-time argparse).

A copy of ``acr_tpu/utils/session.py`` (the port imports nothing of the
JAX package); ``tests/test_torch_port_host.py`` holds the class equal to
the original."""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import yaml


class ConfigSession:
    def __init__(self, cfg, out_dir: str = "active_configs"):
        self.cfg = cfg
        stamp = time.strftime("%Y-%m-%d_%H_%M_%S")
        # cfg.tab names the session, like the reference's decorated tab
        # in the active-config filename (acr/config.py:217,241)
        tag = str(getattr(cfg, "tab", "ACR")).replace(os.sep, "_")
        self.path = os.path.join(out_dir, f"{tag}_{stamp}.yaml")

    def __enter__(self):
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(self.path, "w") as f:
            yaml.safe_dump(dataclasses.asdict(self.cfg), f)
        return self.cfg

    def __exit__(self, *exc):
        if os.path.exists(self.path):
            os.remove(self.path)
        return False
