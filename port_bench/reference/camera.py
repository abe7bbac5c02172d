"""The camera of the demo: weak perspective (s, tx, ty) onto the network
input, the keypoints mapped back into the original frame through the
padding, and the metric translation that puts the root-aligned joints
under a pinhole of focal length f over the input canvas, by linear least
squares (two equations per joint)."""

from __future__ import annotations

import torch


def weak_persp(points: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """points [..., N, 3], cam [..., 3] -> [..., N, 2] in [-1, 1]."""
    return points[..., :2] * cam[..., None, :1] + cam[..., None, 1:3]


def to_original(kp: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """[-1, 1] keypoints [..., N, 2] -> pixels of the original frame;
    offsets [..., 10] = padded (H, W), crop (t, r, b, l), pad (t, r, b, l)."""
    size = offsets[..., None, :2]
    left_top = torch.stack([offsets[..., 5] - offsets[..., 9],
                            offsets[..., 2] - offsets[..., 6]], -1)
    return (kp + 1) * size / 2 + left_top[..., None, :]


def translation(j3d: torch.Tensor, kp_px: torch.Tensor, focal: float,
                size: int) -> torch.Tensor:
    """j3d [..., 21, 3], kp_px [..., 21, 2] -> t [..., 3] minimising
    sum |f (X + t)_xy / (Z + tz) + c - kp|^2 linearised: f tx + (c - u) tz
    = (u - c) Z - f X, and the same in y."""
    j, kp = j3d.double(), kp_px.double()
    c = size / 2.0
    u, v = kp[..., 0], kp[..., 1]
    zero, f = torch.zeros_like(u), torch.full_like(u, focal)
    a = torch.cat([torch.stack([f, zero, c - u], -1),
                   torch.stack([zero, f, c - v], -1)], -2)
    rhs = torch.cat([(u - c) * j[..., 2] - focal * j[..., 0],
                     (v - c) * j[..., 2] - focal * j[..., 1]], -1)
    return torch.linalg.lstsq(a, rhs[..., None]).solution[..., 0]
