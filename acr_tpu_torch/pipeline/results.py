"""Result reorganization to the reference's per-image dict format.

Converts the pipeline's fixed-shape (B, 2, ...) device outputs into the
fp16 numpy per-image dicts the reference produces
(reference: acr/utils.py:1226-1271): one entry per *detected* hand with
cam, cam_trans, poses(48), betas(10), j3d(21), verts(778), pj2d,
pj2d_org and hand_type (0=left, 1=right), plus the left/right-sorted
view the reference computes.

A copy of ``acr_tpu/pipeline/results.py`` (the port imports nothing of
the JAX package); ``tests/test_torch_port_host.py`` holds it equal to
the original.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


_KEYS = ("cam", "cam_trans", "poses", "betas", "j3d", "verts", "pj2d",
         "pj2d_org")


def reorganize_results(outputs: Dict[str, np.ndarray],
                       img_paths: Sequence[str]) -> Dict[str, list]:
    """outputs: pipeline dict with (B, 2, ...) arrays; one path per image.

    Returns {img_path: [hand_dict, ...]} with only detected hands, left
    before right, values float16 (int32 hand_type / bool flag).
    """
    det = np.asarray(outputs["detection_flag"])          # (B, 2) bool
    host = {k: np.asarray(outputs[k]).astype(np.float16) for k in _KEYS}
    results: Dict[str, list] = {}
    for b, path in enumerate(img_paths):
        hands = []
        for hand in (0, 1):          # 0=left, 1=right
            if not det[b, hand]:
                continue
            entry = {k: host[k][b, hand] for k in _KEYS}
            entry["hand_type"] = np.int32(hand)
            entry["detection_flag_cache"] = bool(det[b, hand])
            hands.append(entry)
        results[path] = hands
    return results


def sort_results_by_hand(results: Dict[str, list]) -> Dict[str, dict]:
    """{path: [hand_dicts]} -> {path: {'left': [...], 'right': [...]}}."""
    out = {}
    for name, hands in results.items():
        out[name] = {"left": [], "right": []}
        for h in hands:
            out[name]["left" if int(h["hand_type"]) == 0 else "right"].append(h)
    return out
