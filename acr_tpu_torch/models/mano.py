"""MANO statistical hand model as a pure PyTorch function.

Counterpart of ``acr_tpu/models/mano.py`` (the pure path): the demo
configuration of the reference ManoLayer — ``use_pca=False``,
axis-angle joints, ``flat_hand_mean=False``, ``center_idx=9``
(reference: acr/mano_wrapper.py:18-33, mano/manolayer.py:104-276).
Shape blend, pose blend and skinning are batched einsums; forward
kinematics runs the 3-level x 5-finger batched 4x4 chains.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from acr_tpu_torch.ops.rotations import axis_angle_to_rotmat

# fingertip vertex ids (reference: mano/manolayer.py:244-247)
TIPS_RIGHT = (745, 317, 444, 556, 673)
TIPS_LEFT = (745, 317, 445, 556, 673)

# FK levels (reference: mano/manolayer.py:191-193)
LEV1 = (1, 4, 7, 10, 13)
LEV2 = (2, 5, 8, 11, 14)
LEV3 = (3, 6, 9, 12, 15)
# transform reorder back to joint order (reference: mano/manolayer.py:222)
REORDER_16 = (0, 1, 6, 11, 2, 7, 12, 3, 8, 13, 4, 9, 14, 5, 10, 15)
# output joint order: wrist, thumb..pinky chains with tips interleaved
# (reference: mano/manolayer.py:254)
REORDER_21 = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18,
              10, 11, 12, 19, 7, 8, 9, 20)


class ManoModel(NamedTuple):
    """MANO parameters of one hand side as tensors."""
    v_template: torch.Tensor    # (778, 3)
    shapedirs: torch.Tensor     # (778, 3, 10)
    posedirs: torch.Tensor      # (778, 3, 135)
    j_regressor: torch.Tensor   # (16, 778)
    weights: torch.Tensor       # (778, 16)
    hands_mean: torch.Tensor    # (45,)
    tips: torch.Tensor          # (5,) int64 fingertip vertex ids


def load_mano_model(mano_dir: str, side: str, device=None,
                    dtype=torch.float32) -> Tuple[ManoModel, np.ndarray]:
    """Load one hand side from ``mano_{side}.npz``. Returns (model, faces[1538,3])."""
    with np.load(os.path.join(mano_dir, f"mano_{side}.npz")) as d:
        t = lambda k: torch.as_tensor(np.asarray(d[k]), dtype=dtype,
                                      device=device)
        tips = TIPS_LEFT if side == "left" else TIPS_RIGHT
        model = ManoModel(
            v_template=t("v_template"), shapedirs=t("shapedirs"),
            posedirs=t("posedirs"), j_regressor=t("J_regressor"),
            weights=t("weights"), hands_mean=t("hands_mean"),
            tips=torch.as_tensor(tips, dtype=torch.long, device=device))
        faces = np.asarray(d["faces"], np.int32)
    return model, faces


def _with_translation(rots: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] rigid transforms from [..., 3, 3] and [..., 3]."""
    top = torch.cat([rots, trans[..., None]], dim=-1)              # [...,3,4]
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def mano_forward(model: ManoModel, poses: torch.Tensor, betas: torch.Tensor,
                 center_idx: Optional[int] = 9, add_mean: bool = True):
    """MANO forward pass.

    poses (B, 48) axis-angle [global_orient(3) | 15 joints(45)], with the
    stored mean pose added to the 45 articulation dims when ``add_mean``;
    betas (B, 10). Returns verts (B, 778, 3), joints (B, 21, 3) and the
    root-alignment center (B, 1, 3), or None when ``center_idx`` is None.
    """
    B = poses.shape[0]
    root_aa = poses[:, :3]
    hand_aa = poses[:, 3:]
    if add_mean:
        hand_aa = hand_aa + model.hands_mean[None]

    full_aa = torch.cat([root_aa, hand_aa], dim=1).reshape(B, 16, 3)
    rotmats = axis_angle_to_rotmat(full_aa)                  # (B, 16, 3, 3)
    root_rot = rotmats[:, 0]
    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    pose_map = (rotmats[:, 1:] - eye).reshape(B, 135)

    v_shaped = (torch.einsum("vct,bt->bvc", model.shapedirs, betas)
                + model.v_template[None])
    j_rest = torch.einsum("jv,bvc->bjc", model.j_regressor, v_shaped)
    v_posed = v_shaped + torch.einsum("vcp,bp->bvc", model.posedirs, pose_map)

    lev1, lev2, lev3 = list(LEV1), list(LEV2), list(LEV3)
    root_j = j_rest[:, 0]
    g_root = _with_translation(root_rot, root_j)             # (B, 4, 4)
    rel1 = _with_translation(rotmats[:, lev1], j_rest[:, lev1] - root_j[:, None])
    rel2 = _with_translation(rotmats[:, lev2], j_rest[:, lev2] - j_rest[:, lev1])
    rel3 = _with_translation(rotmats[:, lev3], j_rest[:, lev3] - j_rest[:, lev2])

    g1 = torch.einsum("bij,bfjk->bfik", g_root, rel1)
    g2 = torch.einsum("bfij,bfjk->bfik", g1, rel2)
    g3 = torch.einsum("bfij,bfjk->bfik", g2, rel3)
    g_all = torch.cat([g_root[:, None], g1, g2, g3], dim=1)[:, list(REORDER_16)]

    # remove rest-pose joint location: G' = G - pack(G @ [j; 0])
    j_h = torch.cat([j_rest, torch.zeros_like(j_rest[..., :1])], dim=-1)
    shifted = torch.einsum("bjik,bjk->bji", g_all, j_h)
    g_skin = g_all.clone()
    g_skin[..., 3] = g_skin[..., 3] - shifted

    # linear blend skinning: T(b,v) = sum_j weights[v,j] * G'(b,j)
    t = torch.einsum("vj,bjik->bvik", model.weights, g_skin)
    verts = (torch.einsum("bvik,bvk->bvi", t[:, :, :3, :3], v_posed)
             + t[:, :, :3, 3])

    joints16 = g_all[:, :, :3, 3]
    tips = verts[:, model.tips]                              # (B, 5, 3)
    joints21 = torch.cat([joints16, tips], dim=1)[:, list(REORDER_21)]

    center = None
    if center_idx is not None:
        center = joints21[:, center_idx:center_idx + 1]
        joints21 = joints21 - center
        verts = verts - center
    return verts, joints21, center
