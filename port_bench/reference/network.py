"""The ACR network as plain functions over a state dict.

HRNet-W32 (stem, a 4-Bottleneck layer1, stages of 1, 4 and 3 modules
over 2, 3 and 4 branches of 32/64/128/256 channels, all-to-all sum
fusion) with the 33-class part-segmentation head, then ACR's heads on
the 128 x 128 features plus CoordConv: per hand a parameter map (3 camera
+ 106 channels), a centre map and a cross-hand prior map at 64 x 64; the
part module pools contact and shape features under the predicted part
attention, regresses per-joint 6D offsets and betas, and fuses them into
the parameter map by a 1x1 conv ("concat"). BatchNorm is a folded
per-channel affine (``scale``, ``bias``).

Every weight is read by name from a ``Params`` source. With no tensors it
records each name and shape instead and hands back meta tensors, so
``param_shapes`` lists the state dict by running the forward on the meta
device. Input: uint8 (B, S, S, 3) RGB; output: NHWC maps.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

STAGES = ((1, (32, 64)), (4, (32, 64, 128)), (3, (32, 64, 128, 256)))
HEAD_KINDS = (("params", 106), ("center", 1), ("cam", 3), ("prior", 106))
FEAT_CH = 34            # 32 backbone channels + CoordConv x, y
PARAM_CH = 109          # camera (3) + 16 6D rotations (96) + betas (10)


class Params:
    """Weights by name; with ``tensors`` None it records (name, shape)."""

    def __init__(self, tensors: Optional[Dict[str, torch.Tensor]] = None):
        self.tensors = tensors
        self.spec: List[Tuple[str, Tuple[int, ...]]] = []

    def __call__(self, name: str, *shape: int) -> torch.Tensor:
        if self.tensors is None:
            self.spec.append((name, shape))
            return torch.empty(shape, device="meta")
        t = self.tensors[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        return t


def conv(P, name, x, cout, k, stride=1, bias=False, pad=None):
    cin = x.shape[1]
    w = P(f"{name}.weight", cout, cin, k, k)
    b = P(f"{name}.bias", cout) if bias else None
    return F.conv2d(x, w, b, stride=stride,
                    padding=k // 2 if pad is None else pad)


def bn(P, name, x):
    c = x.shape[1]
    return x * P(f"{name}.scale", c)[:, None, None] + \
        P(f"{name}.bias", c)[:, None, None]


def conv_bn(P, name, x, cout, k=3, stride=1, relu=True, bias=False):
    y = bn(P, f"{name}.bn", conv(P, f"{name}.conv", x, cout, k, stride, bias))
    return F.relu(y) if relu else y


def basic_block(P, name, x):
    c = x.shape[1]
    y = F.relu(bn(P, f"{name}.bn1", conv(P, f"{name}.conv1", x, c, 3)))
    y = bn(P, f"{name}.bn2", conv(P, f"{name}.conv2", y, c, 3))
    return F.relu(y + x)


def bottleneck(P, name, x, downsample):
    y = F.relu(bn(P, f"{name}.bn1", conv(P, f"{name}.conv1", x, 64, 1)))
    y = F.relu(bn(P, f"{name}.bn2", conv(P, f"{name}.conv2", y, 64, 3)))
    y = bn(P, f"{name}.bn3", conv(P, f"{name}.conv3", y, 256, 1))
    res = bn(P, f"{name}.down_bn", conv(P, f"{name}.down_conv", x, 256, 1)) \
        if downsample else x
    return F.relu(y + res)


def hr_module(P, name, xs, channels, multi_out):
    n = len(channels)
    ys = []
    for i in range(n):
        h = xs[i]
        for k in range(4):
            h = basic_block(P, f"{name}.b{i}_{k}", h)
        ys.append(h)
    out = []
    for i in range(n if multi_out else 1):
        acc = ys[i]
        for j in range(n):
            if j > i:
                up = conv_bn(P, f"{name}.fuse_{i}_{j}", ys[j], channels[i],
                             k=1, relu=False)
                f = 2 ** (j - i)
                acc = acc + up.repeat_interleave(f, 2).repeat_interleave(f, 3)
            elif j < i:
                h = ys[j]
                for k in range(i - j):
                    last = k == i - j - 1
                    h = conv_bn(P, f"{name}.fuse_{i}_{j}_{k}", h,
                                channels[i] if last else channels[j], k=3,
                                stride=2, relu=not last)
                acc = acc + h
        out.append(F.relu(acc))
    return out


def backbone(P, image_uint8):
    x = image_uint8.permute(0, 3, 1, 2).float() / 255.0 * 2.0 - 1.0
    x = conv_bn(P, "backbone.stem1", x, 64, stride=2)
    x = conv_bn(P, "backbone.stem2", x, 64, stride=2)
    for k in range(4):
        x = bottleneck(P, f"backbone.layer1_{k}", x, downsample=k == 0)
    xs = [conv_bn(P, "backbone.transition1_0", x, 32),
          conv_bn(P, "backbone.transition1_1_0", x, 64, stride=2)]
    for s, (n_mod, channels) in enumerate(STAGES):
        if s:
            xs = xs + [conv_bn(P, f"backbone.transition{s + 1}_{s + 1}_0",
                               xs[-1], channels[-1], stride=2)]
        for m in range(n_mod):
            last = s == len(STAGES) - 1 and m == n_mod - 1
            xs = hr_module(P, f"backbone.stage{s + 2}_{m}", xs, channels,
                           multi_out=not last)
    return xs[0]


def segm_head(P, feats):
    h, w = feats.shape[2:]
    x = F.interpolate(feats, size=(2 * h, 2 * w), mode="bilinear",
                      align_corners=True)
    x = conv_bn(P, "segm.up1", x, 16, bias=True)
    x = conv_bn(P, "segm.up2", x, 64, bias=True)
    x = conv_bn(P, "segm.out1", x, 33, bias=True)
    return conv(P, "segm.out_conv2", x, 33, 3, bias=True)


def head(P, name, x, cout):
    h = conv_bn(P, f"{name}.trans", x, 64, stride=2, bias=True)
    for k in range(2):
        h = basic_block(P, f"{name}.blk{k}", h)
    return conv(P, f"{name}.out", h, cout, 1, bias=True)


def attention_pool(feats, att):
    """Softmax of each part's attention over the map, then the weighted
    sum of the features: (B, C, H, W), (B, J, H, W) -> (B, J, C)."""
    b, c = feats.shape[:2]
    w = torch.softmax(att.flatten(2), dim=-1)
    return torch.einsum("bjn,bcn->bjc", w, feats.flatten(2))


def forward(P, image_uint8) -> Dict[str, torch.Tensor]:
    feats = backbone(P, image_uint8)                   # (B, 32, 128, 128)
    segm = segm_head(P, feats)                         # (B, 33, 256, 256)
    b, _, h, w = feats.shape
    r = torch.linspace(-1.0, 1.0, h, device=feats.device)
    coords = torch.stack([r[None, :].expand(h, w), r[:, None].expand(h, w)])
    x = torch.cat([feats, coords[None].expand(b, 2, h, w)], dim=1)

    maps = {}
    for side in ("l", "r"):
        for kind, ch in HEAD_KINDS:
            maps[side, kind] = head(P, f"{side}_{kind}_head", x, ch)
        cam = maps[side, "cam"]
        maps[side, "cam"] = torch.cat([1.1 ** cam[:, :1], cam[:, 1:]], 1)

    part_att = segm[:, 1:, ::2, ::2]                   # 32 parts, 128 x 128
    contact = conv_bn(P, "contact_conv", x, 256, bias=True)
    shape = conv(P, "cam_shape_conv", contact, 64, 1, bias=True)
    pooled_c = attention_pool(contact, part_att)       # (B, 32, 256)
    pooled_s = attention_pool(shape, part_att)         # (B, 32, 64)
    # parts 0..15 belong to the right hand, 16..31 to the left
    parts = {"r": slice(0, 16), "l": slice(16, 32)}
    out = {}
    for side in ("l", "r"):
        pc, ps = pooled_c[:, parts[side]], pooled_s[:, parts[side]]
        lc = P(f"{side}_pose_lc.w", 6, 256, 16)
        offs = torch.einsum("ocj,bjc->bjo", lc, pc).reshape(b, 96)
        fc_w = P(f"{side}_shape_fc.weight", 10, 1024)
        fc_b = P(f"{side}_shape_fc.bias", 10)
        betas = ps.transpose(1, 2).reshape(b, 1024) @ fc_w.T + fc_b
        pare = torch.cat([offs, betas], 1)[:, :, None, None]
        glob = torch.cat([maps[side, "cam"], maps[side, "params"]], 1)
        fused_in = torch.cat([glob, maps[side, "cam"],
                              pare.expand(b, 106, *glob.shape[2:])], 1)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        out[f"{side}_params_maps"] = nhwc(
            conv(P, f"{side}_fuse_conv", fused_in, PARAM_CH, 1, bias=True))
        out[f"{side}_center_map"] = nhwc(maps[side, "center"])
        out[f"{side}_prior_maps"] = nhwc(maps[side, "prior"])
    return out


def param_shapes(input_size: int = 512) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every weight's name and shape, in the order the forward reads them."""
    P = Params()
    forward(P, torch.empty((1, input_size, input_size, 3), dtype=torch.uint8,
                           device="meta"))
    return P.spec
