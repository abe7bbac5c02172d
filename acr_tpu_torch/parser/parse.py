"""Map parsing: parameter sampling, cross-hand prior fusion, 6D decode.

Counterpart of ``acr_tpu/parser/parse.py`` (reference:
acr/result_parser.py:7-190). Both hands always occupy a slot and every
decision is masked arithmetic:

* hand-missing fallback: sample flat index 0 with valid=False
  (result_parser.py:107-120); ``detection_flag`` is data, never a
  Python branch on a device value;
* 'cross' prior: each hand's params[3:] get the other hand's prior map
  sampled at the other hand's center, gated to zero when the centers
  are more than ``prior_gate_px`` map cells apart or a hand is missing;
* 'merge': the ``fusion_fc`` Linear over [l, l_prior, r, r_prior],
  applied where both hands are detected.

Output layout: hand axis of size 2, index 0 = left, 1 = right.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from acr_tpu_torch.ops.rotations import rot6d_to_axis_angle
from acr_tpu_torch.parser.center import decode_centers

CAM_DIM = 3
ROT6D = 6
POSE6D = 90            # 15 joints x 6
BETAS = 10
PARAMS = CAM_DIM + ROT6D + POSE6D + BETAS   # 109


def sample_at_index(maps: torch.Tensor, flat_inds: torch.Tensor) -> torch.Tensor:
    """maps (B, H, W, C), flat_inds (B,) -> (B, C): each image's channel
    vector at its flattened spatial index."""
    b, h, w, c = maps.shape
    inds = flat_inds.to(torch.long)
    rows = torch.div(inds, w, rounding_mode="floor")
    return maps[torch.arange(b, device=maps.device), rows, inds % w]


def split_params(params109: torch.Tensor, rot_type: str = "6D",
                 rot_dim: int = 6, theta_num: int = 16,
                 beta_dim: int = 10) -> Dict[str, torch.Tensor]:
    """[cam(3) | orient(rot_dim) | pose((theta_num-1)*rot_dim) | betas]
    -> decoded dict; 6D rotations are Gram-Schmidt decoded to
    axis-angle, 'angular' ones pass through (result_parser.py:24-34)."""
    pose_w = (theta_num - 1) * rot_dim
    cam = params109[..., :CAM_DIM]
    orient = params109[..., CAM_DIM:CAM_DIM + rot_dim]
    pose = params109[..., CAM_DIM + rot_dim:CAM_DIM + rot_dim + pose_w]
    betas = params109[..., CAM_DIM + rot_dim + pose_w:
                      CAM_DIM + rot_dim + pose_w + beta_dim]
    if rot_type == "6D":
        global_orient = rot6d_to_axis_angle(orient)
        hand_pose = rot6d_to_axis_angle(pose)
    else:
        global_orient, hand_pose = orient, pose
    poses = torch.cat([global_orient, hand_pose], dim=-1)
    return {"cam": cam, "global_orient": global_orient,
            "hand_pose": hand_pose, "betas": betas, "poses": poses}


class ParsedHands(NamedTuple):
    params: torch.Tensor         # (B, 2, 109) raw sampled+prior-fused params
    cam: torch.Tensor            # (B, 2, 3)
    poses: torch.Tensor          # (B, 2, 48) axis-angle
    betas: torch.Tensor          # (B, 2, 10)
    detection_flag: torch.Tensor  # (B, 2) bool — [left, right]
    centers: torch.Tensor        # (B, 2, 2) float (x, y) in map coords
    centers_conf: torch.Tensor   # (B, 2)
    flat_inds: torch.Tensor      # (B, 2) int32


def parse_outputs(outputs: Dict[str, torch.Tensor],
                  conf_thresh: float = 0.35,
                  prior_mode: str = "cross",
                  prior_gate_px: float = 32.0,
                  centermap_size: int = 64,
                  merge_params: Optional[Dict[str, torch.Tensor]] = None,
                  nms_kernel: int = 5,
                  max_hand: int = 1,
                  rot_type: str = "6D",
                  rot_dim: int = 6,
                  theta_num: int = 16,
                  beta_dim: int = 10,
                  ) -> ParsedHands:
    """Decode ACRNet's NHWC output maps into per-hand parameters.

    The prior gate compares the two centers' euclidean distance in
    64-map cell units against ``prior_gate_px`` (result_parser.py:44-46).
    ``merge_params`` is the fusion head as {'weight' (212, 424), 'bias'}.
    """
    l_dec = decode_centers(outputs["l_center_map"], max_hand, conf_thresh,
                           nms_kernel=nms_kernel)
    r_dec = decode_centers(outputs["r_center_map"], max_hand, conf_thresh,
                           nms_kernel=nms_kernel)

    # slot 0 = highest-score candidate (inference K=1 semantics)
    l_valid, r_valid = l_dec.valid[:, 0], r_dec.valid[:, 0]
    zero = torch.zeros((), dtype=torch.int32, device=l_valid.device)
    l_ind = torch.where(l_valid, l_dec.flat_inds[:, 0], zero)
    r_ind = torch.where(r_valid, r_dec.flat_inds[:, 0], zero)

    f32 = lambda t: t.to(torch.float32)
    l_params = f32(sample_at_index(outputs["l_params_maps"], l_ind))  # (B, 109)
    r_params = f32(sample_at_index(outputs["r_params_maps"], r_ind))

    both = l_valid & r_valid
    if prior_mode in ("cross", "merge") and outputs.get("l_prior_maps") is not None:
        # sample each prior map at the OTHER hand's center
        l_prior = f32(sample_at_index(outputs["l_prior_maps"], r_ind))  # (B, 106)
        r_prior = f32(sample_at_index(outputs["r_prior_maps"], l_ind))
        dist = torch.linalg.norm(l_dec.yx[:, 0] - r_dec.yx[:, 0], dim=-1)
        gate = (both & (dist <= prior_gate_px))[:, None].to(l_prior.dtype)
        if prior_mode == "cross":
            l_params = torch.cat([l_params[:, :CAM_DIM],
                                  l_params[:, CAM_DIM:] + l_prior * gate], dim=1)
            r_params = torch.cat([r_params[:, :CAM_DIM],
                                  r_params[:, CAM_DIM:] + r_prior * gate], dim=1)
        else:  # 'merge': Linear(106*4 -> 106*2) over [l, l_prior, r, r_prior]
            if merge_params is None:
                raise ValueError("merge mode needs the fusion_fc params")
            x = torch.cat([l_params[:, CAM_DIM:], l_prior,
                           r_params[:, CAM_DIM:], r_prior], dim=-1)
            merged = x @ merge_params["weight"].T + merge_params["bias"]
            mgate = both[:, None]
            n = l_prior.shape[1]
            l_params = torch.cat([l_params[:, :CAM_DIM], torch.where(
                mgate, merged[:, :n], l_params[:, CAM_DIM:])], dim=1)
            r_params = torch.cat([r_params[:, :CAM_DIM], torch.where(
                mgate, merged[:, n:], r_params[:, CAM_DIM:])], dim=1)

    params = torch.stack([l_params, r_params], dim=1)              # (B, 2, 109)
    decoded = split_params(params, rot_type=rot_type, rot_dim=rot_dim,
                           theta_num=theta_num, beta_dim=beta_dim)

    # centers as (x, y) map coords (reference: result_parser.py:173-174)
    div = lambda i: torch.div(i, centermap_size, rounding_mode="floor")
    centers = torch.stack([
        torch.stack([l_ind % centermap_size, div(l_ind)], -1),
        torch.stack([r_ind % centermap_size, div(r_ind)], -1),
    ], dim=1).to(torch.float32)
    conf = torch.stack([
        f32(sample_at_index(outputs["l_center_map"], l_ind)[:, 0]),
        f32(sample_at_index(outputs["r_center_map"], r_ind)[:, 0]),
    ], dim=1)

    return ParsedHands(
        params=params,
        cam=decoded["cam"],
        poses=decoded["poses"],
        betas=decoded["betas"],
        detection_flag=torch.stack([l_valid, r_valid], dim=1),
        centers=centers,
        centers_conf=conf,
        flat_inds=torch.stack([l_ind, r_ind], dim=1).to(torch.int32),
    )
