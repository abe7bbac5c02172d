"""Fused MANO blendshapes + skinning: the CUDA kernel, its plain version,
and the MANO forward around them.

Counterpart of ``acr_tpu/ops/mano_kernel.py``. The vertex-heavy tail of
the MANO forward,

    v_posed = v_template + shapedirs @ betas + posedirs @ pose_map
    T       = weights @ G_skin
    verts   = T[:, :3, :3] @ v_posed + T[:, :3, 3]

runs as one kernel (``acr_mano_fused`` in ``csrc/mano.cu``, the port of
the Pallas ``_fused_kernel``) on the blend coefficients ``[1 | betas |
pose_map]`` and the 16 skinning transforms' top rows, so no 778-vertex
intermediate goes through device memory. The per-joint math (Rodrigues,
the rest joints, the 3-level forward kinematics, the fingertips and the
root alignment) stays in PyTorch, shared with ``models.mano``.

The TPU's lane padding of the vertices (778 -> 896), its batch padding
to a multiple of 8 and its 64-hand VMEM grid are Mosaic and VMEM
workarounds and are not ported: the constants keep the 778 real
vertices, and the kernel takes any batch.

``fused_blend_skin`` runs ``fused_blend_skin_plain`` for tensors on the
CPU and launches the kernel for CUDA tensors, or raises; it never falls
back. ``launch_shape`` gives the kernel's grid for the Python int B,
with no sync. Every operand is checked on every call. ``LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from acr_tpu_torch.models.mano import (
    ManoModel,
    joints_and_align,
    pose_rotations,
    rest_joints,
    skinning_transforms,
)
from acr_tpu_torch.ops import cuda_lib

N_VERTS = 778
N_COEF = 146           # 1 + 10 betas + 135 pose-map entries
# the launch of csrc/mano.cu: HANDS hands and VERTS vertices per block of
# THREADS threads (the 146 coefficients split over its 8 warps)
HANDS = 8
VERTS = 32
THREADS = 256
MAX_GRID_Y = 65535
MAX_BATCH = MAX_GRID_Y * HANDS

# kernel launches since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {"mano_fused": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class ManoLaunch(NamedTuple):
    """One launch of the fused kernel."""
    hands: int                 # hands per block
    verts: int                 # vertices per block
    threads: int               # threads per block
    grid: Tuple[int, int]      # (vertex tiles, hand tiles)


def launch_shape(batch: int) -> ManoLaunch:
    """The launch for ``batch`` hands; raises above ``MAX_BATCH``."""
    if batch < 1:
        raise ValueError(f"launch_shape: batch {batch} < 1")
    grid = (math.ceil(N_VERTS / VERTS), math.ceil(batch / HANDS))
    if grid[1] > MAX_GRID_Y:
        raise ValueError(f"fused_blend_skin: {batch} hands is above the "
                         f"launch limit of {MAX_BATCH}")
    return ManoLaunch(HANDS, VERTS, THREADS, grid)


class ManoKernelData(NamedTuple):
    """Constant operands of the fused kernel (one side)."""
    basis: torch.Tensor        # (146, 3, 778) [template|shapedirs|posedirs] planes
    weights_t: torch.Tensor    # (16, 778) skinning weights, transposed
    j_basis: torch.Tensor      # (11, 16, 3): rest joints = [1|betas] @ j_basis
    hands_mean: torch.Tensor   # (45,)
    tips: torch.Tensor         # (5,) int64 fingertip vertex ids


def build_kernel_data(model: ManoModel) -> ManoKernelData:
    """Pack a ManoModel into the kernel's constants, on the model's device."""
    basis = torch.cat([model.v_template.T[None],
                       model.shapedirs.permute(2, 1, 0),
                       model.posedirs.permute(2, 1, 0)]).contiguous()
    return ManoKernelData(
        basis=basis, weights_t=model.weights.T.contiguous(),
        j_basis=model.j_basis,
        hands_mean=model.hands_mean, tips=model.tips)


def _check_constants(data: ManoKernelData, dev: torch.device) -> None:
    """Check ``basis`` and ``weights_t``: dtype, shape, device, contiguity
    and, on the card, the kernel's alignment."""
    cuda_lib.check("basis", data.basis, torch.float32, (N_COEF, 3, N_VERTS),
                   dev)
    cuda_lib.check("weights_t", data.weights_t, torch.float32, (16, N_VERTS),
                   dev)
    if dev.type == "cuda" and (data.basis.data_ptr() % 8
                               or data.weights_t.data_ptr() % 8):
        raise ValueError("basis and weights_t must be 8-byte aligned")


def fused_blend_skin_plain(data: ManoKernelData, coef: torch.Tensor,
                           g_rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``fused_blend_skin`` (any device): the
    two products of the TPU kernel, then the 9-term affine per vertex."""
    b = coef.shape[0]
    vp = (coef @ data.basis.reshape(N_COEF, 3 * N_VERTS)).reshape(b, 3, N_VERTS)
    t = (g_rows @ data.weights_t).reshape(b, 12, N_VERTS)
    x, y, z = vp[:, 0], vp[:, 1], vp[:, 2]
    return torch.stack([t[:, 4 * i] * x + t[:, 4 * i + 1] * y
                        + t[:, 4 * i + 2] * z + t[:, 4 * i + 3]
                        for i in range(3)], dim=-1)                 # (B, 778, 3)


def fused_blend_skin(data: ManoKernelData, coef: torch.Tensor,
                     g_rows: torch.Tensor) -> torch.Tensor:
    """coef (B, 146), g_rows (B*12, 16) -> verts (B, 778, 3), all fp32
    and contiguous on one device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    dev, b = coef.device, coef.shape[0]
    cuda_lib.check("coef", coef, torch.float32, (b, N_COEF), dev)
    cuda_lib.check("g_rows", g_rows, torch.float32, (b * 12, 16), dev)
    _check_constants(data, dev)
    if dev.type == "cpu":
        return fused_blend_skin_plain(data, coef, g_rows)
    if dev.type != "cuda":
        raise ValueError(f"fused_blend_skin: unsupported device {dev}")
    if b == 0:
        return torch.empty((0, N_VERTS, 3), dtype=torch.float32, device=dev)
    launch_shape(b)        # raises above the grid's limit
    if g_rows.data_ptr() % 16:
        raise ValueError("g_rows must be 16-byte aligned")
    out = torch.empty((b, N_VERTS, 3), dtype=torch.float32, device=dev)
    cuda_lib.launch(cuda_lib.library().acr_mano_fused, dev, coef.data_ptr(),
                    g_rows.data_ptr(), data.basis.data_ptr(),
                    data.weights_t.data_ptr(), b, out.data_ptr())
    LAUNCHES["mano_fused"] += 1
    return out


def blend_skin_operands(data: ManoKernelData, poses: torch.Tensor,
                        betas: torch.Tensor, add_mean: bool = True):
    """The per-joint math of the MANO forward: poses (B, 48), betas
    (B, 10) -> the kernel's coef (B, 146) and g_rows (B*12, 16), and the
    joints' world transforms (B, 16, 4, 4)."""
    b = poses.shape[0]
    rotmats, pose_map = pose_rotations(data.hands_mean, poses, add_mean)
    g_all, g_skin = skinning_transforms(rotmats,
                                        rest_joints(data.j_basis, betas))
    ones = torch.ones((b, 1), dtype=betas.dtype, device=betas.device)
    coef = torch.cat([ones, betas, pose_map], dim=1)
    g_rows = g_skin[:, :, :3, :].permute(0, 2, 3, 1).reshape(b * 12, 16)
    return coef, g_rows.contiguous(), g_all


def mano_forward_fused(data: ManoKernelData, poses: torch.Tensor,
                       betas: torch.Tensor, center_idx: Optional[int] = 9,
                       add_mean: bool = True):
    """Drop-in fused equivalent of ``models.mano.mano_forward``: the same
    arguments and outputs (verts, joints21, center)."""
    coef, g_rows, g_all = blend_skin_operands(data, poses, betas, add_mean)
    verts = fused_blend_skin(data, coef, g_rows)
    return joints_and_align(g_all, verts, data.tips, center_idx)
