"""MANO as the demo runs it: full 45-dimensional articulation in
axis-angle with the mean pose added (no PCA, ``flat_hand_mean`` False),
shape and pose blend shapes, forward kinematics over the 16-joint tree,
linear blend skinning, 21 joints (16 joint origins and 5 fingertip
vertices) in the order of the reference's ``ManoLayer``, and the mesh
and joints aligned on joint 9 (the middle finger's root)."""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from port_bench.reference.parse import axis_angle_to_rotmat

PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
TIPS = {"left": (745, 317, 445, 556, 673), "right": (745, 317, 444, 556, 673)}
ORDER_21 = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18,
            10, 11, 12, 19, 7, 8, 9, 20)
ALIGN = 9


def load(mano_dir: str, side: str, device) -> Dict[str, torch.Tensor]:
    """The arrays of ``mano_{side}.npz`` on ``device`` (float64 math)."""
    with np.load(os.path.join(mano_dir, f"mano_{side}.npz")) as d:
        m = {k: torch.as_tensor(np.asarray(d[k], np.float64), device=device)
             for k in ("v_template", "shapedirs", "posedirs", "J_regressor",
                       "weights", "hands_mean")}
        m["faces"] = np.asarray(d["faces"], np.int64)
    m["tips"] = torch.as_tensor(TIPS[side], device=device)
    return m


def forward(m: Dict[str, torch.Tensor], poses: torch.Tensor,
            betas: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """poses (B, 48), betas (B, 10) -> root-aligned verts (B, 778, 3) and
    joints (B, 21, 3), in float64."""
    poses, betas = poses.double(), betas.double()
    b = poses.shape[0]
    aa = torch.cat([poses[:, :3], poses[:, 3:] + m["hands_mean"]], 1)
    rot = axis_angle_to_rotmat(aa.reshape(b, 16, 3))
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    v_shaped = m["v_template"] + torch.einsum("vct,bt->bvc", m["shapedirs"],
                                              betas)
    joints = torch.einsum("jv,bvc->bjc", m["J_regressor"], v_shaped)
    v_posed = v_shaped + torch.einsum("vcp,bp->bvc", m["posedirs"],
                                      (rot[:, 1:] - eye).reshape(b, 135))
    world = []
    for j, p in enumerate(PARENTS):
        local = torch.zeros((b, 4, 4), dtype=rot.dtype, device=rot.device)
        local[:, :3, :3] = rot[:, j]
        local[:, :3, 3] = joints[:, j] - (joints[:, p] if p >= 0 else 0)
        local[:, 3, 3] = 1
        world.append(local if p < 0 else world[p] @ local)
    g = torch.stack(world, 1)                                 # (B, 16, 4, 4)
    skin = g.clone()
    skin[..., :3, 3] -= torch.einsum("bjik,bjk->bji", g[..., :3, :3], joints)
    t = torch.einsum("vj,bjik->bvik", m["weights"], skin)
    verts = torch.einsum("bvik,bvk->bvi", t[..., :3, :3], v_posed) \
        + t[..., :3, 3]
    j21 = torch.cat([g[:, :, :3, 3], verts[:, m["tips"]]], 1)[:, list(ORDER_21)]
    root = j21[:, ALIGN:ALIGN + 1]
    return verts - root, j21 - root
