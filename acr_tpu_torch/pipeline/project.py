"""Camera projection + metric translation recovery, on the tensors' device.

Counterpart of ``acr_tpu/pipeline/project.py`` (reference:
acr/utils.py:384-519): weak-perspective projection, the offsets mapping
back to the original image, and the closed-form weighted least squares
for the metric camera translation, solved by reorthogonalized
Gram-Schmidt exactly as the JAX package writes it (``_lstsq_gs3``; not a
normal-equation solve, whose squared condition number drifts tz in fp32).
"""

from __future__ import annotations

from typing import Tuple

import torch


def weak_persp_project(points: torch.Tensor, cam: torch.Tensor,
                       keep_dim: bool = False) -> torch.Tensor:
    """points [..., N, 3], cam [..., 3] = (s, tx, ty) -> [..., N, 2 or 3]."""
    s = cam[..., None, 0:1]
    t = cam[..., None, 1:3]
    xy = points[..., :2] * s + t
    if keep_dim:
        return torch.cat([xy, points[..., 2:3]], dim=-1)
    return xy


def kp2d_to_org_image(kp2d: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Normalized [-1, 1] keypoints -> original-image pixels.

    offsets [..., 10] = [pad_h, pad_w, crop_trbl(4), pad_trbl(4)]
    (reference: acr/utils.py:392-397).
    """
    img_pad_size = offsets[..., :2]
    crop_trbl = offsets[..., 2:6]
    pad_trbl = offsets[..., 6:10]
    left_top = torch.stack([crop_trbl[..., 3] - pad_trbl[..., 3],
                            crop_trbl[..., 0] - pad_trbl[..., 0]], dim=-1)
    return ((kp2d + 1) * img_pad_size[..., None, :] / 2
            + left_top[..., None, :])


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _lstsq_gs3(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Least squares for (..., N, 3) q, (..., N) c via reorthogonalized
    Gram-Schmidt (CGS2) on the 3 columns + back substitution."""
    q0, q1, q2 = q[..., 0], q[..., 1], q[..., 2]
    r00 = torch.linalg.norm(q0, dim=-1)
    e0 = q0 / r00[..., None]
    r01 = _dot(e0, q1)
    v1 = q1 - r01[..., None] * e0
    s = _dot(e0, v1)                  # second orthogonalization pass
    r01 = r01 + s
    v1 = v1 - s[..., None] * e0
    r11 = torch.linalg.norm(v1, dim=-1)
    e1 = v1 / r11[..., None]
    r02 = _dot(e0, q2)
    v2 = q2 - r02[..., None] * e0
    r12 = _dot(e1, v2)
    v2 = v2 - r12[..., None] * e1
    s0 = _dot(e0, v2)
    r02 = r02 + s0
    v2 = v2 - s0[..., None] * e0
    s1 = _dot(e1, v2)
    r12 = r12 + s1
    v2 = v2 - s1[..., None] * e1
    r22 = torch.linalg.norm(v2, dim=-1)
    e2 = v2 / r22[..., None]
    t2 = _dot(e2, c) / r22
    t1 = (_dot(e1, c) - r12 * t2) / r11
    t0 = (_dot(e0, c) - r01 * t1 - r02 * t2) / r00
    return torch.stack([t0, t1, t2], dim=-1)


def estimate_translation_ls(j3d: torch.Tensor, pj2d_px: torch.Tensor,
                            focal: float = 1265.0,
                            img_size: Tuple[int, int] = (512, 512)) -> torch.Tensor:
    """j3d [..., 21, 3] root-aligned joints, pj2d_px [..., 21, 2] pixel
    projections on the ``img_size`` canvas -> [..., 3] translation.

    Per joint the pinhole model gives two linear equations in t:
      f*tx + (cx - u)*tz = (u - cx)*Z - f*X
      f*ty + (cy - v)*tz = (v - cy)*Z - f*Y
    All confidences are 1 for model-generated joints.
    """
    cx, cy = img_size[0] / 2.0, img_size[1] / 2.0
    u, v = pj2d_px[..., 0], pj2d_px[..., 1]
    zeros = torch.zeros_like(u)
    fcol = torch.full_like(u, focal)
    rows_u = torch.stack([fcol, zeros, cx - u], dim=-1)
    rows_v = torch.stack([zeros, fcol, cy - v], dim=-1)
    q = torch.cat([rows_u, rows_v], dim=-2)                   # (..., 2N, 3)
    c = torch.cat([(u - cx) * j3d[..., 2] - focal * j3d[..., 0],
                   (v - cy) * j3d[..., 2] - focal * j3d[..., 1]], dim=-1)
    return _lstsq_gs3(q, c)
