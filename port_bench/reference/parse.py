"""Centre decoding, parameter sampling and rotations.

Each hand's centre is the highest cell of its centre map after a 5 x 5
max-pool suppression; it counts as detected above the threshold. The
parameter map is sampled at the centre, and with the "cross" prior the
other hand's prior map, sampled at the other hand's centre, is added to
the 106 non-camera channels when both hands are detected and their
centres lie within ``gate`` cells. The 16 6D rotations are decoded by
Gram-Schmidt and turned into axis-angle.

``picks`` lets a judge sample at the program's own centres, where they
are within a near-tie of the reference's best (``judge``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """[..., 6] read as a 3 x 2 matrix -> rotation [..., 3, 3] whose
    columns are the Gram-Schmidt basis of the two columns."""
    a = x.reshape(x.shape[:-1] + (3, 2))
    b1 = F.normalize(a[..., 0], dim=-1, eps=1e-6)
    a2 = a[..., 1]
    b2 = F.normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1, dim=-1,
                     eps=1e-6)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def rotmat_to_axis_angle(r: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> axis-angle [..., 3], through the unit
    quaternion of the largest of its four candidate components."""
    m = r.double()
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cands = torch.stack([
        torch.stack([1 + tr, m[..., 2, 1] - m[..., 1, 2],
                     m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1]], -1),
        torch.stack([m[..., 2, 1] - m[..., 1, 2], 1 + 2 * m[..., 0, 0] - tr,
                     m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0]], -1),
        torch.stack([m[..., 0, 2] - m[..., 2, 0], m[..., 0, 1] + m[..., 1, 0],
                     1 + 2 * m[..., 1, 1] - tr, m[..., 1, 2] + m[..., 2, 1]], -1),
        torch.stack([m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0],
                     m[..., 1, 2] + m[..., 2, 1], 1 + 2 * m[..., 2, 2] - tr], -1),
    ], -2)                                                   # [..., 4, 4]
    pick = torch.stack([1 + tr, 1 + 2 * m[..., 0, 0] - tr,
                        1 + 2 * m[..., 1, 1] - tr, 1 + 2 * m[..., 2, 2] - tr],
                       -1).argmax(-1)
    q = torch.gather(cands, -2, pick[..., None, None].expand(
        pick.shape + (1, 4)))[..., 0, :]
    q = q / q.norm(dim=-1, keepdim=True)
    q = torch.where(q[..., :1] < 0, -q, q)                   # w >= 0
    s = q[..., 1:].norm(dim=-1)
    angle = 2 * torch.atan2(s, q[..., 0])
    k = torch.where(s > 1e-12, angle / s.clamp(min=1e-300),
                    torch.full_like(s, 2.0))
    return (q[..., 1:] * k[..., None]).to(r.dtype)


def axis_angle_to_rotmat(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle [..., 3] -> rotation [..., 3, 3]."""
    a = aa.double()
    theta = a.norm(dim=-1, keepdim=True)
    axis = a / theta.clamp(min=1e-12)
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    k = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], -1
                    ).reshape(a.shape[:-1] + (3, 3))
    s, c = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    return (eye + s * k + (1 - c) * (k @ k)).to(aa.dtype)


def nms_max(center_map: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> the map with every cell that is not the maximum of its
    5 x 5 neighbourhood set to 0."""
    pooled = F.max_pool2d(center_map[:, None], 5, stride=1, padding=2)[:, 0]
    return torch.where(pooled == center_map, center_map,
                       torch.zeros_like(center_map))


def parse(maps: Dict[str, torch.Tensor], conf_thresh: float = 0.35,
          gate: float = 32.0, picks: Optional[torch.Tensor] = None
          ) -> Dict[str, torch.Tensor]:
    """NHWC maps -> per hand (axis 1: left, right): ``flat`` centre index,
    ``score``, ``detected``, ``params`` (109, sampled and prior-fused),
    ``cam`` (3), ``poses`` (48 axis-angle),
    ``betas`` (10). ``picks`` (B, 2) overrides the centres."""
    b, h, w = maps["l_center_map"].shape[:3]
    flat, score = [], []
    for k, side in enumerate("lr"):
        cmap = maps[f"{side}_center_map"][..., 0].float()
        sup = nms_max(cmap).reshape(b, h * w)
        ind = sup.argmax(dim=1) if picks is None else picks[:, k].long()
        flat.append(ind)
        score.append(cmap.reshape(b, h * w).gather(1, ind[:, None])[:, 0])
    flat, score = torch.stack(flat, 1), torch.stack(score, 1)
    detected = score > conf_thresh
    ind = torch.where(detected, flat, torch.zeros_like(flat))
    rows = torch.arange(b, device=ind.device)

    def sample(name, which):
        m = maps[name].float().reshape(b, h * w, -1)
        return m[rows, ind[:, which]]

    params = [sample("l_params_maps", 0), sample("r_params_maps", 1)]
    yx = torch.stack([ind // w, ind % w], -1).float()
    near = (yx[:, 0] - yx[:, 1]).norm(dim=-1) <= gate
    both = (detected[:, 0] & detected[:, 1] & near).float()[:, None]
    priors = [sample("l_prior_maps", 1), sample("r_prior_maps", 0)]
    for k in range(2):
        params[k] = torch.cat([params[k][:, :3],
                               params[k][:, 3:] + priors[k] * both], 1)
    p = torch.stack(params, 1)                                # (B, 2, 109)
    rot = rotmat_to_axis_angle(rot6d_to_rotmat(
        p[..., 3:99].reshape(b, 2, 16, 6))).reshape(b, 2, 48)
    return {"flat": ind, "score": score, "detected": detected, "params": p,
            "cam": p[..., :3], "poses": rot, "betas": p[..., 99:109]}
