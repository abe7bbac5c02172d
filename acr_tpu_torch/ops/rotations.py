"""Batched 3D rotation conversions in PyTorch.

Counterpart of ``acr_tpu/ops/rotations.py`` for the functions the parser
and MANO call, with the same numerical contracts:

* axis-angle -> rotmat goes through a unit quaternion with the
  ``||aa + 1e-8||`` norm guard (reference: mano/manolayer.py:423-434);
* 6D -> rotmat is the Gram-Schmidt *column* construction with the
  ``max(norm, 1e-6)`` guard (reference: acr/utils.py:362-376);
* rotmat -> axis-angle keeps the kornia-derived branch logic with its
  eps=1e-6 branch selection, and zeroes NaNs (acr/utils.py:359, 773-906).

All functions take any leading batch dims and branch on no tensor value,
except ``transform_rot_representation``, JAX's host converter through
scipy (a copy).
"""

from __future__ import annotations

import torch


def axis_angle_to_quat(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> unit quaternion [..., 4] (w, x, y, z)."""
    angle = torch.linalg.norm(aa + 1e-8, dim=-1, keepdim=True)
    axis = aa / angle
    half = angle * 0.5
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] (w, x, y, z), any norm -> rotmat [..., 3, 3]."""
    q = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        ww + xx - yy - zz, 2 * (xy - wz),     2 * (wy + xz),
        2 * (wz + xy),     ww - xx + yy - zz, 2 * (yz - wx),
        2 * (xz - wy),     2 * (wx + yz),     ww - xx - yy + zz,
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_rotmat(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3]."""
    return quat_to_rotmat(axis_angle_to_quat(aa))


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation representation [..., 6] -> rotmat [..., 3, 3].

    The 6 numbers are read as a 3x2 matrix whose columns seed the first
    two basis vectors; the result stacks (b1, b2, b3) as matrix columns.
    """
    a = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = a[..., 0], a[..., 1]
    eps = 1e-6
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True), min=eps)
    proj = torch.sum(b1 * a2, dim=-1, keepdim=True)
    u2 = a2 - proj * b1
    b2 = u2 / torch.clamp(torch.linalg.norm(u2, dim=-1, keepdim=True), min=eps)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_quat(rotmat: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4] (w, x, y, z).

    Shepperd-style 4-branch selection keyed on ``m[2,2] < eps`` and
    diagonal comparisons of the *transposed* matrix, blended with masks.
    """
    batch_shape = rotmat.shape[:-2]
    m = rotmat.reshape((-1, 3, 3)).transpose(-1, -2)

    m00, m01, m02 = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    m10, m11, m12 = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    m20, m21, m22 = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]

    mask_d2 = m22 < eps
    mask_d0_d1 = m00 > m11
    mask_d0_nd1 = m00 < -m11

    t0 = 1 + m00 - m11 - m22
    q0 = torch.stack([m12 - m21, t0, m01 + m10, m20 + m02], dim=-1)
    t1 = 1 - m00 + m11 - m22
    q1 = torch.stack([m20 - m02, m01 + m10, t1, m12 + m21], dim=-1)
    t2 = 1 - m00 - m11 + m22
    q2 = torch.stack([m01 - m10, m20 + m02, m12 + m21, t2], dim=-1)
    t3 = 1 + m00 + m11 + m22
    q3 = torch.stack([t3, m12 - m21, m20 - m02, m01 - m10], dim=-1)

    c0 = mask_d2 & mask_d0_d1
    c1 = mask_d2 & ~mask_d0_d1
    c2 = ~mask_d2 & mask_d0_nd1
    c3 = ~mask_d2 & ~mask_d0_nd1
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    sel = lambda c, v: torch.where(c, v, zero)
    q = (sel(c0[:, None], q0) + sel(c1[:, None], q1)
         + sel(c2[:, None], q2) + sel(c3[:, None], q3))
    t = sel(c0, t0) + sel(c1, t1) + sel(c2, t2) + sel(c3, t3)
    q = q * 0.5 / torch.sqrt(t)[:, None]
    return q.reshape(batch_shape + (4,))


def quat_to_axis_angle(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] (w, x, y, z) -> axis-angle [..., 3], with the
    shortest-arc sign fix and the small-angle limit k -> 2
    (reference: acr/utils.py:773-823)."""
    w = quat[..., 0]
    xyz = quat[..., 1:4]
    sin_sq = torch.sum(xyz * xyz, dim=-1)
    sin_theta = torch.sqrt(sin_sq)
    two_theta = 2.0 * torch.where(w < 0.0, torch.atan2(-sin_theta, -w),
                                  torch.atan2(sin_theta, w))
    k_pos = two_theta / torch.where(sin_theta == 0.0,
                                    torch.ones_like(sin_theta), sin_theta)
    k = torch.where(sin_sq > 0.0, k_pos, torch.full_like(k_pos, 2.0))
    return xyz * k[..., None]


def rotmat_to_axis_angle(rotmat: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3]; NaNs become 0."""
    aa = quat_to_axis_angle(rotmat_to_quat(rotmat))
    return torch.where(torch.isnan(aa), torch.zeros_like(aa), aa)


def rot6d_to_axis_angle(rot6d: torch.Tensor) -> torch.Tensor:
    """Flattened 6D rots [..., K*6] -> flattened axis-angle [..., K*3]
    (the parser's ``rot6D_to_angular``, reference: acr/utils.py:378-382)."""
    lead = rot6d.shape[:-1]
    k = rot6d.shape[-1] // 6
    mats = rot6d_to_rotmat(rot6d.reshape(lead + (k, 6)))
    return rotmat_to_axis_angle(mats).reshape(lead + (k * 3,))


def transform_rot_representation(rot, input_type: str = "mat",
                                 out_type: str = "vec",
                                 euler_degrees: bool = False):
    """Host-side conversion between rotation representations via scipy.

    Types: 'mat' (3x3), 'quat' (xyzw), 'vec' (rotation vector),
    'euler' (intrinsic xyz). Covers the capability of the reference's
    converter (acr/utils.py:521-549) with one deliberate change: euler
    units are explicit via ``euler_degrees`` — the reference guesses
    degrees-vs-radians from magnitude (``rot.max() < 4``), silently
    rescaling genuine small-degree inputs.
    """
    import numpy as np
    from scipy.spatial.transform import Rotation as R
    rot = np.asarray(rot)
    loaders = {
        "mat": R.from_matrix,
        "quat": R.from_quat,
        "vec": R.from_rotvec,
        "euler": lambda a: R.from_euler("xyz", a, degrees=euler_degrees),
    }
    if input_type not in loaders:
        raise ValueError(f"unknown input_type: {input_type}")
    r = loaders[input_type](rot)
    writers = {
        "mat": r.as_matrix,
        "quat": r.as_quat,
        "vec": r.as_rotvec,
        "euler": lambda: r.as_euler("xyz", degrees=euler_degrees),
    }
    if out_type not in writers:
        raise ValueError(f"unknown out_type: {out_type}")
    return writers[out_type]()
