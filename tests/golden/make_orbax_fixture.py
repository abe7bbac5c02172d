#!/usr/bin/env python
"""Regenerate tests/golden/orbax_small/ and tests/golden/orbax_small.npz
(run from the repo root; needs JAX and orbax).

``orbax_small/`` is what ``acr_tpu.io.params.save_params_orbax`` writes
for a small params tree (orbax's default layout: OCDBT with zstd), and
``orbax_small.npz`` holds the same leaves under their '/'-joined paths.
npz has no bfloat16, so a bf16 leaf is stored as its uint16 bits and
its path is listed under ``BF16_KEY``. The PyTorch port reads the
directory without orbax (``acr_tpu_torch.io.orbax``) and is held to the
npz, here and on hosts that have no orbax.
"""

import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from acr_tpu.io.params import flatten_params, save_params_orbax

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "orbax_small")
OUT_NPZ = os.path.join(HERE, "orbax_small.npz")
BF16_KEY = "bfloat16_leaves"


def fixture_tree():
    """fp32 (1-D, 2-D and a 4-D conv kernel), bf16, int8, int32, bool and
    0-d leaves; ``big/kernel`` compresses to more than orbax's 1024-byte
    inline limit, so its chunk lives in a data file, not in the node."""
    rng = np.random.RandomState(0)
    return {"params": {
        "conv": {"kernel": rng.randn(3, 3, 2, 4).astype(np.float32),
                 "bias": rng.randn(4).astype(np.float32)},
        "dense": {"kernel": rng.randn(5, 3).astype(np.float32)},
        "big": {"kernel": rng.randn(16, 32).astype(np.float32)},
        "half": jnp.asarray(rng.randn(2, 7), jnp.bfloat16),
        "q": {"kernel_q": rng.randint(-128, 128, (3, 3, 2, 2)).astype(np.int8),
              "steps": np.arange(6, dtype=np.int32).reshape(2, 3)},
        "mask": rng.rand(9) > 0.5,
        "scale": np.float32(0.2),
    }}


def main():
    tree = fixture_tree()
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    save_params_orbax(OUT_DIR, tree)
    flat = flatten_params(tree)
    bf16 = sorted(k for k, v in flat.items() if v.dtype == jnp.bfloat16)
    arrays = {k: (v.view(np.uint16) if k in bf16 else v)
              for k, v in flat.items()}
    arrays[BF16_KEY] = np.asarray(bf16)
    np.savez(OUT_NPZ, **arrays)
    print("orbax fixture regenerated:", sorted(flat))


if __name__ == "__main__":
    main()
