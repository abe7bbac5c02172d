"""Ground-truth centre-map rendering (the training side of CenterMap).

Counterpart of ``acr_tpu/parser/centermap_gt.py``. The reference's
CenterMap carries gaussian kernels for generating training heat maps
beside its NMS pools (reference: acr/result_parser.py:205-216,
kernel_sizes config.py:185, sigma=1). ``render_center_maps`` draws the
same maps as one batched op of fixed shape; with ``parser.center``'s
decode it round-trips: render N centres, decode N peaks.
"""

from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel(kernel_size: int, sigma: float = 1.0) -> np.ndarray:
    """(k, k) unnormalized gaussian, peak 1 at the center cell
    (reference: acr/result_parser.py:210-214)."""
    x = np.arange(kernel_size, dtype=np.float64)
    y = x[:, None]
    x0 = y0 = (kernel_size - 1) // 2
    return np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma ** 2))


def render_center_maps(centers_yx: torch.Tensor, valid: torch.Tensor,
                       size: int = 64, sigma: float = 1.0) -> torch.Tensor:
    """Render gaussian peaks at given centers.

    centers_yx: (B, N, 2) float map coords; valid: (B, N) bool ->
    (B, size, size, 1) heatmap, max-combined across instances, on the
    centres' device.
    """
    dev = centers_yx.device
    grid = torch.arange(size, dtype=torch.float32, device=dev)
    ys, xs = grid[:, None], grid[None, :]
    cy = centers_yx[..., 0][:, :, None, None]       # (B, N, 1, 1)
    cx = centers_yx[..., 1][:, :, None, None]
    d2 = (ys - cy) ** 2 + (xs - cx) ** 2
    g = torch.exp(-d2 / (2.0 * sigma ** 2))
    g = torch.where(valid[:, :, None, None], g, 0.0)
    return g.amax(dim=1)[..., None]
