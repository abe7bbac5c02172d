"""The work of the kernels every MANO-based architecture shares, counted
from shapes, and the card's peaks: the yardstick of the roofline and MFU
metrics. A network's FLOPs per frame are its architecture's
(``archs/<architecture>.py`` ``flops_per_frame``).

- B1, the binned rasterizer: the face table (26 float rows per face) read
  once and the outputs (face id, two barycentrics and 16 attribute planes
  per pixel) written once; the edge test (23 operations) of every (face,
  pixel in the face's clipped bounding box) pair.
- B4, the fused MANO kernel: a copy of ``fused_work``'s arithmetic at a
  launch of ``hands`` hands: coefficients, skinning rows, the blend basis
  and the weights read once, the vertices written once; the two products
  and the affine.
"""

from __future__ import annotations

import torch

# NVIDIA's H100 SXM5 data sheet, dense: bf16 on the tensor cores; fp32
# outside them (TF32 off), counting an FFMA as two operations; HBM3.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.4e12, "fp32": 66.9e12,
                              "bytes_s": 3.35e12},
}

EDGE_OPS = 23
FACE_ROWS = 26
PIXEL_OUT_BYTES = 19 * 4
MANO_VERTS, MANO_COEF = 778, 146


def raster_work(screen_faces: torch.Tensor, n_faces_padded: int,
                size: int):
    """(bytes, operations) of one B1 launch: ``screen_faces`` (F, 3, 2)
    pixel positions of the live faces' corners."""
    lo = screen_faces.amin(1)
    hi = screen_faces.amax(1)
    # pixel centres x + 0.5 inside [lo, hi], clipped to the image
    first = torch.ceil(lo - 0.5).clamp(0, size)
    last = torch.floor(hi - 0.5).clamp(-1, size - 1)
    n = (last - first + 1).clamp(min=0)
    pairs = int((n[:, 0] * n[:, 1]).sum())
    n_bytes = 4 * FACE_ROWS * n_faces_padded + PIXEL_OUT_BYTES * size * size
    return n_bytes, EDGE_OPS * pairs


def mano_work(hands: int):
    """(bytes, operations) of one B4 launch at ``hands`` hands."""
    n_bytes = 4 * (hands * MANO_COEF + hands * 192
                   + MANO_COEF * 3 * MANO_VERTS + 16 * MANO_VERTS
                   + hands * MANO_VERTS * 3)
    return n_bytes, hands * MANO_VERTS * (2 * (MANO_COEF * 3 + 12 * 16) + 18)


def bound_s(n_bytes: float, n_ops: float, peaks: dict) -> float:
    """The least time the card could take: bytes over the memory rate or
    fp32 operations over the fp32 peak, whichever is larger."""
    return max(n_bytes / peaks["bytes_s"], n_ops / peaks["fp32"])
