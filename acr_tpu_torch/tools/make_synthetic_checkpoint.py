"""Create a random-weight checkpoint npz for tests, benches and demos.

Counterpart of ``tools/make_synthetic_checkpoint.py``. The real
checkpoint is a registered download (reference README.md:41); this
writes a structurally identical stand-in, an npz of flax paths that both
packages load, so the full pipeline runs without it. The weights are
``io.params.init_params`` from ``--seed`` (flax's initializers; the bits
differ from JAX's, whose random streams are other), with JAX's damping
rule: random init has no BatchNorm statistics, so deep residual stacks
blow up (the 1.1^x camera scale then overflows), and every folded-BN
scale (flax's init, ones) is damped by 0.2; the centre heads' output
bias is lifted by 0.5 so the centre maps clear the 0.35 confidence
threshold and synthetic-weight runs still detect hands.

Usage:
  python -m acr_tpu_torch.tools.make_synthetic_checkpoint \\
      [--out checkpoints/wild.npz] [--seed 0]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import torch

from acr_tpu_torch.config import _REPO_ROOT
from acr_tpu_torch.io.params import init_params, save_params_npz

BN_DAMP = 0.2
CENTER_LIFT = 0.5


def damp(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """JAX's rule (``tools/make_synthetic_checkpoint.py:33-44``): every
    folded-BN ``scale`` is flax's init (ones) times 0.2, and each
    ``*center_head.out.bias`` is lifted by 0.5. Returns a new dict."""
    out = {}
    for key, value in params.items():
        names = key.split(".")
        if names[-1] == "scale":
            value = torch.ones_like(value) * BN_DAMP
        elif (len(names) >= 3 and names[-3].endswith("center_head")
              and names[-2] == "out" and names[-1] == "bias"):
            value = value + CENTER_LIFT
        out[key] = value
    return out


def make_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """The damped seeded state dict of the canonical ACRNet."""
    return damp(init_params(torch.Generator().manual_seed(seed)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(_REPO_ROOT, "checkpoints",
                                                  "wild.npz"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    params = make_params(args.seed)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_params_npz(args.out, params)
    n = sum(v.numel() for v in params.values())
    print(f"wrote {args.out} ({n/1e6:.2f}M params)")


if __name__ == "__main__":
    main()
