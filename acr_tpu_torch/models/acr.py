"""ACR network: HRNet backbone + global heads + attention-collaboration part module.

Counterpart of ``acr_tpu/models/acr.py`` (reference: acr/model.py:23-329)
in its canonical form:

* global module, per hand (left/right): a params map (106ch), a center
  heatmap (1ch), a camera map (3ch, scale made positive via 1.1**x), and
  a cross-hand prior map (106ch), all at 64x64;
* part module: the predicted 33-class part segmentation (256x256)
  becomes 32 spatial attention maps at 128x128; Hadamard attention
  pooling reduces 256-d contact features and 64-d shape features to
  per-part vectors; per-joint locally-connected heads regress 6D pose
  offsets and a Linear head regresses shape; the 106-vector refines the
  global params map per ``offset_mode``.

The network runs NCHW inside and returns the JAX package's NHWC maps.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from acr_tpu_torch.models.hrnet import HRNetBackbone, SegmNet
from acr_tpu_torch.models.layers import (
    BasicBlock,
    ConvBN,
    conv,
    downsample_nearest_half,
    get_coord_maps,
)

N_PARTS = 32          # 16 per hand; channel 0 of the segm map is background
PARAMS_CH = 106       # 6D rots (96) + betas (10)
CAM_CH = 3
MAP_SIZE = 64
FEAT_CH = 32 + 2      # backbone features + CoordConv xy


class HeadStack(nn.Module):
    """stride-2 transition conv + N BasicBlocks + 1x1 output conv
    (reference `_make_head_layers`, acr/model.py:288-313)."""

    def __init__(self, in_ch: int, out_ch: int, width: int = 64,
                 num_blocks: int = 2):
        super().__init__()
        self.trans = ConvBN(in_ch, width, kernel=3, stride=2, use_bias=True)
        self.num_blocks = num_blocks
        for k in range(num_blocks):
            self.add_module(f"blk{k}", BasicBlock(width, width))
        self.out = conv(width, out_ch, 1, pad=0, use_bias=True)

    def forward(self, x):
        x = self.trans(x)
        for k in range(self.num_blocks):
            x = getattr(self, f"blk{k}")(x)
        return self.out(x)


class LocallyConnected(nn.Module):
    """Per-position 1x1 'conv' over a 16x1 joint grid (PARE-style head).

    out[b,o,j] = sum_c w[o,c,j] * x[b,j,c] with unshared weights per
    joint (reference: acr/model.py:541-569). ``x`` is (B, positions,
    in_ch); ``w`` keeps the checkpoint's (O, C, J) layout.
    """

    def __init__(self, out_ch: int = 6, in_ch: int = 256, positions: int = 16):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(out_ch, in_ch, positions))

    def forward(self, x):
        return torch.einsum("ocj,bjc->boj", self.w, x)


def hadamard_pool(features: torch.Tensor, attention: torch.Tensor) -> torch.Tensor:
    """Spatial-softmax attention pooling.

    features (B,C,H,W), attention (B,J,H,W) -> (B,J,C): softmax over H*W
    per part, then a batched matmul with the features (reference:
    acr/model.py:103-113). The (B,J,C) result is the JAX package's layout.
    """
    b, c, h, w = features.shape
    j = attention.shape[1]
    att = torch.softmax(attention.reshape(b, j, h * w), dim=-1)
    feat = features.reshape(b, c, h * w)
    return torch.bmm(att, feat.transpose(1, 2))


class ACRNet(nn.Module):
    """Full-frame network: uint8 image (B,S,S,3) -> output maps dict.

    ``params_ch`` is the per-hand parameter-map width without the camera
    (cfg.map_channels; 106 for the 6D layout). ``offset_mode`` selects
    how the part module's pooled 106-vector refines the global params
    map: 'concat' (1x1 conv over the concatenation, the reference's
    forward), 'offset' (add to the non-cam channels) or 'replace'.
    """

    def __init__(self, inter_prior: bool = True, head_block_num: int = 2,
                 params_ch: int = PARAMS_CH, offset_mode: str = "concat"):
        super().__init__()
        if offset_mode not in ("offset", "replace", "concat"):
            raise ValueError(f"offset_mode must be offset|replace|concat, "
                             f"got {offset_mode!r}")
        self.inter_prior = inter_prior
        self.params_ch = params_ch
        self.offset_mode = offset_mode
        self.backbone = HRNetBackbone()
        self.segm = SegmNet()
        kinds = {"params": params_ch, "center": 1, "cam": CAM_CH}
        if inter_prior:
            kinds["prior"] = params_ch
        self.kinds = tuple(kinds)
        for side in ("l", "r"):
            for kind, out_ch in kinds.items():
                self.add_module(f"{side}_{kind}_head", HeadStack(
                    FEAT_CH, out_ch, num_blocks=head_block_num))
        self.contact_conv = ConvBN(FEAT_CH, 256, kernel=3, use_bias=True)
        self.cam_shape_conv = conv(256, 64, 1, pad=0, use_bias=True)
        pose_w = params_ch - 10
        self.per_joint = pose_w // 16
        for side in ("l", "r"):
            self.add_module(f"{side}_pose_lc",
                            LocallyConnected(out_ch=self.per_joint))
            self.add_module(f"{side}_shape_fc", nn.Linear(64 * 16, 10))
            if offset_mode == "concat":
                self.add_module(f"{side}_fuse_conv", conv(
                    2 * (CAM_CH + params_ch), CAM_CH + params_ch, 1, pad=0,
                    use_bias=True))

    def _part_refine(self, side: str, params_map: torch.Tensor,
                     contact: torch.Tensor, shape: torch.Tensor) -> torch.Tensor:
        b = contact.shape[0]
        pose_w = self.params_ch - 10
        # (B,6,16) -> per-joint-contiguous 96-vector [(j0 6d), (j1 6d), ...]
        offs = getattr(self, f"{side}_pose_lc")(contact)
        offs = offs.transpose(1, 2).reshape(b, pose_w)
        # channel-major flatten (c outer, j inner) of the (B,16,64) shape
        # vectors (acr_tpu/models/acr.py:265)
        shape_flat = shape.transpose(1, 2).reshape(b, 64 * 16)
        betas = getattr(self, f"{side}_shape_fc")(shape_flat)
        pare = torch.cat([offs, betas], dim=-1)                    # (B,106)
        mh, mw = params_map.shape[2:]
        pare_bcast = pare[:, :, None, None].expand(b, self.params_ch, mh, mw)
        cam = params_map[:, :CAM_CH]
        if self.offset_mode == "offset":
            return torch.cat([cam, params_map[:, CAM_CH:] + pare_bcast], dim=1)
        if self.offset_mode == "replace":
            return torch.cat([cam, pare_bcast], dim=1)
        fused_in = torch.cat([params_map, cam, pare_bcast], dim=1)
        return getattr(self, f"{side}_fuse_conv")(fused_in)

    def forward(self, image_uint8: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.backbone(image_uint8)                         # (B,32,H,W)
        pred_segm = self.segm(feats)                               # (B,33,2H,2W)
        att_src = downsample_nearest_half(pred_segm)
        b, _, h, w = feats.shape
        coords = get_coord_maps(h, feats.dtype, feats.device)
        x = torch.cat([feats, coords.expand(b, 2, h, w)], dim=1)

        maps = {}
        for side in ("l", "r"):
            params = getattr(self, f"{side}_params_head")(x)
            center = getattr(self, f"{side}_center_head")(x)
            cam = getattr(self, f"{side}_cam_head")(x)
            # positive scale via 1.1^s (reference: acr/model.py:95-96)
            cam = torch.cat([torch.pow(1.1, cam[:, :1]), cam[:, 1:]], dim=1)
            maps[f"{side}_params"] = torch.cat([cam, params], dim=1)
            maps[f"{side}_center"] = center
            maps[f"{side}_prior"] = (
                getattr(self, f"{side}_prior_head")(x)
                if self.inter_prior else None)

        part_att = att_src[:, 1:]                                  # (B,32,H,W)
        contact_feats = self.contact_conv(x)                       # (B,256,H,W)
        shape_feats = self.cam_shape_conv(contact_feats)           # (B,64,H,W)
        pooled_contact = hadamard_pool(contact_feats, part_att)    # (B,32,256)
        pooled_shape = hadamard_pool(shape_feats, part_att)        # (B,32,64)
        # parts 0..15 are RIGHT, 16..31 LEFT (reference: acr/model.py:141-146)
        per_side = {"r": (pooled_contact[:, :16], pooled_shape[:, :16]),
                    "l": (pooled_contact[:, 16:], pooled_shape[:, 16:])}
        for side in ("l", "r"):
            maps[f"{side}_params"] = self._part_refine(
                side, maps[f"{side}_params"], *per_side[side])

        nhwc = lambda t: None if t is None else t.permute(0, 2, 3, 1)
        return {
            "l_params_maps": nhwc(maps["l_params"]),
            "r_params_maps": nhwc(maps["r_params"]),
            "l_center_map": nhwc(maps["l_center"]),
            "r_center_map": nhwc(maps["r_center"]),
            "l_prior_maps": nhwc(maps["l_prior"]),
            "r_prior_maps": nhwc(maps["r_prior"]),
            "segms": nhwc(pred_segm),
        }
