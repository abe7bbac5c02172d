"""Center-heatmap decoding with fixed shapes, in PyTorch.

Counterpart of ``acr_tpu/parser/center.py`` (reference:
acr/result_parser.py:195-264): max-pool NMS, top-K peaks, and
``valid = score > conf_thresh`` carried as data. Every image yields K
candidate slots, so no decode step reads a device value on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


def nms_heatmap(center_map: torch.Tensor, kernel: int = 5) -> torch.Tensor:
    """Keep only local maxima: x * (maxpool(x) == x).

    center_map: (B, H, W) or (B, H, W, 1). torch MaxPool2d with stride 1
    and symmetric padding (k-1)//2, whose padding never wins a tie.
    """
    squeeze = center_map.ndim == 4
    x = center_map[..., 0] if squeeze else center_map
    pad = (kernel - 1) // 2
    pooled = F.max_pool2d(x[:, None], kernel, stride=1, padding=pad)[:, 0]
    out = torch.where(pooled == x, x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    return out[..., None] if squeeze else out


class CenterDecode(NamedTuple):
    """Per-image top-K center candidates (fixed shapes)."""
    flat_inds: torch.Tensor   # (B, K) int32 — index into flattened H*W
    yx: torch.Tensor          # (B, K, 2) float32 — (row, col)
    scores: torch.Tensor      # (B, K) float32
    valid: torch.Tensor       # (B, K) bool — score > conf_thresh


def decode_centers(center_map: torch.Tensor, k: int = 1,
                   conf_thresh: float = 0.35,
                   nms_kernel: int = 5) -> CenterDecode:
    """NMS + per-image top-K + confidence mask; center_map (B, H, W, 1).

    Ties go to the lower flat index, as ``jax.lax.top_k`` orders them: a
    stable descending sort.
    """
    b, h, w = center_map.shape[:3]
    nmsed = nms_heatmap(center_map, nms_kernel)[..., 0].reshape(b, h * w)
    scores, inds = torch.sort(nmsed, dim=1, descending=True, stable=True)
    scores, inds = scores[:, :k], inds[:, :k]
    ys = torch.div(inds, w, rounding_mode="floor").to(torch.float32)
    xs = (inds % w).to(torch.float32)
    return CenterDecode(
        flat_inds=inds.to(torch.int32),
        yx=torch.stack([ys, xs], dim=-1),
        scores=scores,
        valid=scores > conf_thresh,
    )
