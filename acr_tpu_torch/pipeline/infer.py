"""End-to-end inference: uint8 frame batch -> hands, on one torch device.

Counterpart of ``acr_tpu/pipeline/infer.py``:

    backbone -> heads -> center decode -> parameter sampling ->
    cross-hand prior -> 6D decode -> MANO -> weak-persp projection ->
    metric translation solve -> original-image keypoint mapping

with fixed shapes: both hands always occupy a slot (axis 1: [left,
right]) and ``detection_flag`` is data, not control flow, so the chain
issues device work only and reads nothing back.

fp32 means fp32: building a pipeline turns TF32 off for cuDNN
convolutions and cuBLAS matmuls (cuDNN runs fp32 convolutions in TF32
by default, about three significant digits).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from acr_tpu_torch.config import Config
from acr_tpu_torch.io.params import load_params
from acr_tpu_torch.models.acr import ACRNet
from acr_tpu_torch.models.mano import load_mano_model, mano_forward
from acr_tpu_torch.parser.parse import parse_outputs
from acr_tpu_torch.pipeline.project import (
    estimate_translation_ls,
    kp2d_to_org_image,
    weak_persp_project,
)


def check_slice(cfg: Config) -> None:
    """Raise NotImplementedError for every option value the port does
    not run yet, naming its ROADMAP item. The TPU layout rewrites
    (``s2d_*``, ``merged_heads``) are not options here: the port builds
    the canonical network whatever they say."""
    unported = [
        (cfg.temporal_optimization, "-t (OneEuro smoothing): ROADMAP A8"),
        (cfg.model_precision != "fp32",
         f"model_precision={cfg.model_precision!r}: ROADMAP A6 (bf16)"),
        (cfg.quantize != "none", f"quantize={cfg.quantize!r}: ROADMAP A13"),
        (cfg.data_parallel > 1,
         f"data_parallel={cfg.data_parallel}: ROADMAP A14"),
        (cfg.renderer == "native", "renderer='native': ROADMAP A15"),
        (cfg.use_pallas_mano == "on",
         "use_pallas_mano='on' (fused MANO kernel B4): ROADMAP A12"),
        (cfg.demo_mode != "image",
         f"demo_mode={cfg.demo_mode!r}: ROADMAP A9"),
        (cfg.renderer != "none" and cfg.save_visualization_on_img
         and cfg.render_size >= 1024,
         f"render_size={cfg.render_size} (banded kernel B3): ROADMAP A11"),
        (bool(set(cfg.show_items) - {"mesh"}),
         f"show_items={cfg.show_items!r} (aux views): ROADMAP A10"),
        (not cfg.jit_translation_solve,
         "jit_translation_solve=False (native host solve): ROADMAP A15"),
        (cfg.interactive_vis, "interactive_vis: ROADMAP A9"),
        (cfg.profile_dir is not None, "profile_dir: ROADMAP A15"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(f"not ported to acr_tpu_torch yet: {what}")


def set_fp32_math() -> None:
    """Full fp32 in cuDNN convolutions and cuBLAS matmuls (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _mano_projection_tail(mano_l, mano_r, poses, betas, cam, offsets,
                          cfg: Config) -> Dict[str, torch.Tensor]:
    """MANO -> weak-persp -> translation -> org-image tail.

    poses (B,2,48), betas (B,2,10), cam (B,2,3), offsets (B,10).
    """
    align = cfg.align_idx if cfg.mano_mesh_root_align else None
    verts_l, j3d_l, _ = mano_forward(mano_l, poses[:, 0], betas[:, 0], align)
    verts_r, j3d_r, _ = mano_forward(mano_r, poses[:, 1], betas[:, 1], align)
    verts = torch.stack([verts_l, verts_r], dim=1)      # (B, 2, 778, 3)
    j3d = torch.stack([j3d_l, j3d_r], dim=1)            # (B, 2, 21, 3)
    verts_camed = weak_persp_project(verts, cam, keep_dim=True)
    pj2d = weak_persp_project(j3d, cam)                 # [-1, 1]
    pj2d_px = (pj2d + 1.0) * (cfg.input_size / 2.0)     # reference: utils.py:404
    cam_trans = estimate_translation_ls(
        j3d, pj2d_px, focal=cfg.focal_length,
        img_size=(cfg.input_size, cfg.input_size))
    return {
        "verts": verts, "j3d": j3d, "verts_camed": verts_camed,
        "pj2d": pj2d, "pj2d_org": kp2d_to_org_image(pj2d, offsets[:, None, :]),
        "cam_trans": cam_trans,
    }


def forward_fn(net: ACRNet, mano_l, mano_r, image: torch.Tensor,
               offsets: torch.Tensor, cfg: Config, return_maps: bool = False,
               merge_params: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """(net, manos, uint8 image (B,S,S,3), offsets (B,10)) -> output dict
    with hand axis [left, right]."""
    outputs = net(image)
    parsed = parse_outputs(
        outputs,
        conf_thresh=cfg.centermap_conf_thresh,
        prior_mode=cfg.prior_mode if cfg.inter_prior else "none",
        prior_gate_px=cfg.prior_gate_px,
        centermap_size=cfg.centermap_size,
        merge_params=merge_params,
        nms_kernel=cfg.kernel_sizes[-1],
        max_hand=cfg.max_hand,
        rot_type=cfg.Rot_type,
        rot_dim=cfg.rot_dim,
        theta_num=cfg.mano_theta_num,
        beta_dim=cfg.beta_dim)
    out = {
        "params": parsed.params,
        "cam": parsed.cam,
        "poses": parsed.poses,
        "betas": parsed.betas,
        "detection_flag": parsed.detection_flag,
        "centers": parsed.centers,
        "centers_conf": parsed.centers_conf,
    }
    out.update(_mano_projection_tail(mano_l, mano_r, parsed.poses,
                                     parsed.betas, parsed.cam, offsets, cfg))
    if return_maps:
        out["l_center_map"] = outputs["l_center_map"].float()
        out["r_center_map"] = outputs["r_center_map"].float()
        out["segms"] = outputs["segms"].float()
    return out


class ACRPipeline:
    """Owns the network, the MANO assets and the device.

    ``params`` is a state dict of the canonical ACRNet (``init_params``
    or ``io.params.from_flax``); None loads ``cfg.model_path``, an npz
    of flax paths. ``merge_params`` is the merge-mode fusion head.
    """

    def __init__(self, cfg: Config, params: Optional[Dict[str, torch.Tensor]] = None,
                 device="cpu", merge_params=None):
        check_slice(cfg)
        set_fp32_math()
        self.cfg = cfg
        self.device = torch.device(device)
        if params is None:
            params, merge_params = load_params(cfg.model_path)
        self.net = ACRNet(inter_prior=cfg.inter_prior,
                          head_block_num=cfg.head_block_num,
                          params_ch=cfg.map_channels,
                          offset_mode=cfg.offset_mode)
        self.net.load_state_dict(params, strict=True)
        self.net.eval().requires_grad_(False).to(self.device)
        self.merge_params = None if merge_params is None else {
            k: v.to(self.device) for k, v in merge_params.items()}
        self.mano_l, faces_l = load_mano_model(cfg.mano_model_path, "left",
                                               device=self.device)
        self.mano_r, faces_r = load_mano_model(cfg.mano_model_path, "right",
                                               device=self.device)
        self.faces = np.stack([faces_l, faces_r])      # (2, 1538, 3)

    @torch.no_grad()
    def __call__(self, image, offsets, return_maps: bool = False
                 ) -> Dict[str, torch.Tensor]:
        """image uint8 (B, S, S, 3), offsets float32 (B, 10); numpy or
        tensors. Returns device tensors without synchronizing."""
        image = torch.as_tensor(image).to(self.device)
        offsets = torch.as_tensor(offsets, dtype=torch.float32
                                  ).to(self.device)
        return forward_fn(self.net, self.mano_l, self.mano_r, image, offsets,
                          self.cfg, return_maps=return_maps,
                          merge_params=self.merge_params)
