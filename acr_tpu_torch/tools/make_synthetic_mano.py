"""Generate deterministic synthetic MANO-shaped assets for tests/benches.

The port's copy of ``tools/make_synthetic_mano.py``: the same arrays
from the same seed (``model_data/mano`` holds its output).

The real MANO pickles are license-gated (reference README.md:40) and not
distributed with either repo. For CI, benchmarking, and development we
synthesize assets with the exact shapes/structure of the real model:

  v_template   (778, 3)   — points sampled around a 16-joint hand skeleton
  shapedirs    (778, 3, 10)
  posedirs     (778, 3, 135)
  J_regressor  (16, 778)  — row-normalized soft assignment (rows sum to 1)
  weights      (778, 16)  — row-normalized skinning weights
  faces        (1538, 3)  — local nearest-neighbour triangulation
  hands_mean   (45,)
  kintree_table (2, 16)   — MANO topology: 5 fingers x 3 joints + wrist

Geometry is hand-*like* (correct kinematic topology, plausible scale in
meters) so FK/LBS/skinning tests exercise realistic numbers, but it is
NOT the MANO statistical model. Run
``python -m acr_tpu_torch.tools.convert_mano`` on real pickles for
production.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

N_VERTS = 778
N_JOINTS = 16
N_FACES = 1538

# MANO joint layout (matches the FK levels hard-coded in the reference,
# mano/manolayer.py:191-193): wrist=0; fingers are chains of 3:
# index (1,2,3), middle (4,5,6), pinky (7,8,9), ring (10,11,12), thumb (13,14,15)
KINTREE_PARENTS = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14])

# base direction (palm frame) and segment length per finger chain root
_FINGER_DIRS = {
    1: np.array([1.0, 0.25, 0.0]),    # index
    4: np.array([1.0, 0.05, 0.0]),    # middle
    7: np.array([1.0, -0.35, 0.0]),   # pinky
    10: np.array([1.0, -0.15, 0.0]),  # ring
    13: np.array([0.55, 0.6, 0.15]),  # thumb
}


def _skeleton_joints() -> np.ndarray:
    joints = np.zeros((N_JOINTS, 3))
    seg = {1: 0.09, 4: 0.095, 7: 0.075, 10: 0.088, 13: 0.07}
    for root, d in _FINGER_DIRS.items():
        d = d / np.linalg.norm(d)
        base = d * seg[root]
        joints[root] = base
        joints[root + 1] = base + d * seg[root] * 0.45
        joints[root + 2] = joints[root + 1] + d * seg[root] * 0.35
    return joints


def make_assets(side: str, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed + (1 if side == "left" else 0))
    joints = _skeleton_joints()
    if side == "left":
        joints = joints * np.array([1.0, 1.0, 1.0])  # mirror applied via shapedirs sign

    # sample vertices as noisy offsets around bone segments
    verts = np.zeros((N_VERTS, 3))
    seg_ids = rng.randint(0, N_JOINTS, size=N_VERTS)
    for i, j in enumerate(seg_ids):
        p = KINTREE_PARENTS[j]
        a = joints[j]
        b = joints[p] if p >= 0 else joints[j]
        t = rng.rand()
        verts[i] = a * t + b * (1 - t) + rng.randn(3) * 0.012

    # skinning weights: softmax over negative distance to joints
    d = np.linalg.norm(verts[:, None, :] - joints[None, :, :], axis=-1)
    w = np.exp(-d / 0.01)
    weights = w / w.sum(axis=1, keepdims=True)

    # joint regressor: soft assignment concentrated near each joint
    jr = np.exp(-d.T / 0.004)
    j_regressor = jr / jr.sum(axis=1, keepdims=True)

    shapedirs = rng.randn(N_VERTS, 3, 10) * 0.003
    posedirs = rng.randn(N_VERTS, 3, 135) * 0.0008
    hands_mean = rng.randn(45) * 0.1

    # LOCAL triangulation: connect each vertex to its nearest
    # neighbours, so face bounding boxes sit at the inter-vertex
    # spacing like the real MANO surface mesh. (The previous
    # convex-hull triangulation produced faces spanning the whole
    # cloud — mean screen bbox ~53px vs ~6px for real meshes — which
    # made every rendered frame overflow the binned rasterizer's
    # per-tile capacity and fall back to the exact kernel, so benches
    # measured an unrealistic worst-case render load.)
    d2 = ((verts[:, None, :] - verts[None, :, :]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1)
    idx = np.arange(N_VERTS)
    faces = np.concatenate([
        np.stack([idx, order[:, 1], order[:, 2]], axis=1),
        np.stack([idx, order[:, 2], order[:, 3]], axis=1),
    ]).astype(np.int32)[:N_FACES]

    kintree = np.stack([KINTREE_PARENTS.astype(np.int64),
                        np.arange(N_JOINTS, dtype=np.int64)])

    out = {
        "v_template": verts.astype(np.float32),
        "shapedirs": shapedirs.astype(np.float32),
        "posedirs": posedirs.astype(np.float32),
        "J_regressor": j_regressor.astype(np.float32),
        "weights": weights.astype(np.float32),
        "faces": faces,
        "hands_mean": hands_mean.astype(np.float32),
        "hands_components": np.eye(45, dtype=np.float32),
        "kintree_table": kintree,
        "side": np.array(side),
    }
    if side == "left":
        out["shapedirs"][:, 0, :] *= -1
    return out


def write_assets(out_dir: str, seed: int = 0) -> None:
    """Both sides' npz in ``out_dir``, each written atomically."""
    from acr_tpu_torch.io.params import savez_atomic
    os.makedirs(out_dir, exist_ok=True)
    for side in ("left", "right"):
        savez_atomic(os.path.join(out_dir, f"mano_{side}.npz"),
                     make_assets(side, seed))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out_dir", default="model_data/mano")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    write_assets(args.out_dir, args.seed)
    print(f"wrote synthetic MANO assets to {args.out_dir}")


if __name__ == "__main__":
    main()
