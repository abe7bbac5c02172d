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
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from acr_tpu_torch.ops.rotations import axis_angle_to_rotmat
from acr_tpu_torch.utils.device import resolve_device

# fingertip vertex ids (reference: mano/manolayer.py:244-247)
TIPS_RIGHT = (745, 317, 444, 556, 673)
TIPS_LEFT = (745, 317, 445, 556, 673)

# FK levels (reference: mano/manolayer.py:191-193): joints 1, 4, .., 13,
# then 2, 5, .., 14, then 3, 6, .., 15, as slices, which index a device
# tensor without an index tensor
LEV1 = slice(1, None, 3)
LEV2 = slice(2, None, 3)
LEV3 = slice(3, None, 3)
# transform reorder back to joint order (reference: mano/manolayer.py:222)
REORDER_16 = (0, 1, 6, 11, 2, 7, 12, 3, 8, 13, 4, 9, 14, 5, 10, 15)
# output joint order: wrist, thumb..pinky chains with tips interleaved
# (reference: mano/manolayer.py:254)
REORDER_21 = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18,
              10, 11, 12, 19, 7, 8, 9, 20)

# the reorders as index tensors, one per (order, device)
_DEVICE_INDEX: Dict[Tuple[Tuple[int, ...], torch.device], torch.Tensor] = {}


def device_index(order: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``order`` as an int64 index tensor on ``device``, built on the
    first call for that device. A Python list indexing a device tensor is
    copied from pageable host memory, with a host wait, on every call,
    and a CUDA graph cannot hold that copy."""
    idx = _DEVICE_INDEX.get((order, device))
    if idx is None:
        idx = torch.tensor(order, dtype=torch.long, device=device)
        _DEVICE_INDEX[(order, device)] = idx
    return idx


class ManoModel(NamedTuple):
    """MANO parameters of one hand side as tensors."""
    v_template: torch.Tensor    # (778, 3)
    shapedirs: torch.Tensor     # (778, 3, 10)
    posedirs: torch.Tensor      # (778, 3, 135)
    j_regressor: torch.Tensor   # (16, 778)
    weights: torch.Tensor       # (778, 16)
    hands_mean: torch.Tensor    # (45,)
    tips: torch.Tensor          # (5,) int64 fingertip vertex ids
    j_basis: torch.Tensor       # (11, 16, 3): rest joints = [1|betas] @ j_basis


def rest_joint_basis(j_regressor: np.ndarray, v_template: np.ndarray,
                     shapedirs: np.ndarray) -> np.ndarray:
    """The rest joints as a function of betas, j = J_reg @ (v_t +
    shapedirs @ betas) = [1|betas] @ j_basis: (11, 16, 3) float32.

    Summed on the host by numpy in float32 with the JAX package's own
    expressions and C-contiguous operands (acr_tpu/ops/mano_kernel.py:
    73-77), so it equals JAX's bit for bit; torch's order of the 778-term
    sums follows the host's BLAS and threads (ROADMAP C6)."""
    jr = np.ascontiguousarray(j_regressor, np.float32)
    j0 = jr @ np.ascontiguousarray(v_template, np.float32)             # (16, 3)
    jsh = np.einsum("jv,vct->tjc", jr,
                    np.ascontiguousarray(shapedirs, np.float32))       # (10, 16, 3)
    return np.concatenate([j0[None], jsh], axis=0)


def load_mano_model(mano_dir: str, side: str, device="cuda",
                    dtype=torch.float32) -> Tuple[ManoModel, np.ndarray]:
    """Load one hand side from ``mano_{side}.npz`` onto ``device`` (the
    card unless ``device="cpu"``; raises without a card). Returns (model,
    faces[1538,3])."""
    device = resolve_device(device)
    with np.load(os.path.join(mano_dir, f"mano_{side}.npz")) as d:
        t = lambda k: torch.as_tensor(np.asarray(d[k]), dtype=dtype,
                                      device=device)
        tips = TIPS_LEFT if side == "left" else TIPS_RIGHT
        model = ManoModel(
            v_template=t("v_template"), shapedirs=t("shapedirs"),
            posedirs=t("posedirs"), j_regressor=t("J_regressor"),
            weights=t("weights"), hands_mean=t("hands_mean"),
            tips=torch.as_tensor(tips, dtype=torch.long, device=device),
            j_basis=torch.as_tensor(rest_joint_basis(
                d["J_regressor"], d["v_template"], d["shapedirs"]),
                dtype=dtype, device=device))
        faces = np.asarray(d["faces"], np.int32)
    return model, faces


def _with_translation(rots: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] rigid transforms from [..., 3, 3] and [..., 3]."""
    top = torch.cat([rots, trans[..., None]], dim=-1)              # [...,3,4]
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def pose_rotations(hands_mean: torch.Tensor, poses: torch.Tensor,
                   add_mean: bool = True):
    """(B, 48) axis-angle poses -> rotmats (B, 16, 3, 3) and the pose map
    (B, 135), ``rotmats[:, 1:] - I`` flattened."""
    B = poses.shape[0]
    root_aa = poses[:, :3]
    hand_aa = poses[:, 3:]
    if add_mean:
        hand_aa = hand_aa + hands_mean[None]
    full_aa = torch.cat([root_aa, hand_aa], dim=1).reshape(B, 16, 3)
    rotmats = axis_angle_to_rotmat(full_aa)                  # (B, 16, 3, 3)
    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    return rotmats, (rotmats[:, 1:] - eye).reshape(B, 135)


def rest_joints(j_basis: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """(B, 10) betas -> (B, 16, 3) rest joints, [1|betas] @ j_basis."""
    ones = torch.ones((betas.shape[0], 1), dtype=betas.dtype,
                      device=betas.device)
    return torch.einsum("bt,tjc->bjc", torch.cat([ones, betas], dim=1),
                        j_basis)


def skinning_transforms(rotmats: torch.Tensor, j_rest: torch.Tensor):
    """3-level forward kinematics: rotmats (B, 16, 3, 3), rest joints
    (B, 16, 3) -> the joints' world transforms G (B, 16, 4, 4) in joint
    order, and the skinning transforms G' = G - pack(G @ [j; 0])."""
    root_j = j_rest[:, 0]
    g_root = _with_translation(rotmats[:, 0], root_j)        # (B, 4, 4)
    rel1 = _with_translation(rotmats[:, LEV1], j_rest[:, LEV1] - root_j[:, None])
    rel2 = _with_translation(rotmats[:, LEV2], j_rest[:, LEV2] - j_rest[:, LEV1])
    rel3 = _with_translation(rotmats[:, LEV3], j_rest[:, LEV3] - j_rest[:, LEV2])

    g1 = torch.einsum("bij,bfjk->bfik", g_root, rel1)
    g2 = torch.einsum("bfij,bfjk->bfik", g1, rel2)
    g3 = torch.einsum("bfij,bfjk->bfik", g2, rel3)
    g_all = torch.cat([g_root[:, None], g1, g2, g3], dim=1)[
        :, device_index(REORDER_16, rotmats.device)]

    # remove rest-pose joint location: G' = G - pack(G @ [j; 0])
    j_h = torch.cat([j_rest, torch.zeros_like(j_rest[..., :1])], dim=-1)
    shifted = torch.einsum("bjik,bjk->bji", g_all, j_h)
    g_skin = g_all.clone()
    g_skin[..., 3] = g_skin[..., 3] - shifted
    return g_all, g_skin


def joints_and_align(g_all: torch.Tensor, verts: torch.Tensor,
                     tips: torch.Tensor, center_idx: Optional[int]):
    """The 21 output joints (16 joint origins + 5 fingertip vertices, in
    the reference order) and the root alignment on ``center_idx``.
    Returns (verts, joints21, center or None)."""
    joints16 = g_all[:, :, :3, 3]
    joints21 = torch.cat([joints16, verts[:, tips]], dim=1)[
        :, device_index(REORDER_21, verts.device)]
    center = None
    if center_idx is not None:
        center = joints21[:, center_idx:center_idx + 1]
        joints21 = joints21 - center
        verts = verts - center
    return verts, joints21, center


def mano_forward(model: ManoModel, poses: torch.Tensor, betas: torch.Tensor,
                 center_idx: Optional[int] = 9, add_mean: bool = True):
    """MANO forward pass.

    poses (B, 48) axis-angle [global_orient(3) | 15 joints(45)], with the
    stored mean pose added to the 45 articulation dims when ``add_mean``;
    betas (B, 10). Returns verts (B, 778, 3), joints (B, 21, 3) and the
    root-alignment center (B, 1, 3), or None when ``center_idx`` is None.
    """
    rotmats, pose_map = pose_rotations(model.hands_mean, poses, add_mean)
    v_shaped = (torch.einsum("vct,bt->bvc", model.shapedirs, betas)
                + model.v_template[None])
    # the rest joints from the basis the fused path reads too, so that
    # both paths place every joint alike (ROADMAP C6)
    j_rest = rest_joints(model.j_basis, betas)
    v_posed = v_shaped + torch.einsum("vcp,bp->bvc", model.posedirs, pose_map)
    g_all, g_skin = skinning_transforms(rotmats, j_rest)

    # linear blend skinning: T(b,v) = sum_j weights[v,j] * G'(b,j)
    t = torch.einsum("vj,bjik->bvik", model.weights, g_skin)
    verts = (torch.einsum("bvik,bvk->bvi", t[:, :, :3, :3], v_posed)
             + t[:, :, :3, 3])
    return joints_and_align(g_all, verts, model.tips, center_idx)
