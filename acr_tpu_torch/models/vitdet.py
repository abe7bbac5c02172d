"""ViTDet-H with cascade box heads: the person detector of HaMeR's demo
(Li et al., "Exploring Plain Vision Transformer Backbones for Object
Detection", ECCV 2022, arXiv 2203.16527; detectron2's
``cascade_mask_rcnn_vitdet_h_75ep`` without its mask head).

* Backbone (detectron2 ``ViT``): the normalised, zero-padded square image
  through a 16 x 16 patch convolution into a (S / 16)^2 grid of width
  1280, plus the (1, 197, 1280) position table without its class entry,
  its 14 x 14 grid bicubically resized to the grid; 32 pre-norm blocks
  (``models.hamer.Block``: LayerNorm eps 1e-6, 16 heads of 80, MLP 5120,
  exact GELU), each with decomposed relative positions, windowed in 14 x
  14 windows but for blocks 7, 15, 23 and 31, which attend globally. No
  last norm.
* Simple feature pyramid: scales 4 (ConvT, channel LayerNorm, GELU,
  ConvT), 2 (ConvT), 1 and 1/2 (max pool), each then a 1 x 1 and a 3 x 3
  convolution to 256 without bias, each with a channel LayerNorm (eps
  1e-6); p6 = ``max_pool2d(p5, 1, 2)``.
* RPN: two 3 x 3 convolutions with ReLU, objectness (3 anchors) and
  deltas (12) over p2-p6; anchors of sizes 32-512 at strides 4-64, ratios
  0.5, 1, 2, offset 0; per level the top min(1000, n) proposals, clipped
  to the image, empty ones dropped, NMS 0.7 within the level; the top
  1000 over the levels.
* Cascade: three stages of ROIAlignV2 7 x 7 over p2-p5, four 3 x 3
  convolutions (256, channel LayerNorm, ReLU), a 12544 -> 1024 linear
  with ReLU, 81 class logits and a class-agnostic box with weights (10,
  10, 5, 5), (20, 20, 10, 10), (30, 30, 15, 15); each later stage pools
  the clipped boxes of the stage before; scores the mean of the three
  stages' softmax, boxes the third stage's; per class score > 0.25, NMS
  0.5, the top 100.

Everything after the backbone runs at fixed shapes with validity masks
(``ops.detect``'s NMS and ROIAlignV2), so the detector issues device
work only and reads nothing back. The widths are in ``DIMS``; the
modules' names are detectron2's (``backbone.net.*``,
``backbone.simfp_*``, ``proposal_generator.rpn_head.*``,
``roi_heads.box_head.<k>.*``, ``roi_heads.box_predictor.<k>.*``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from acr_tpu_torch.models import hamer as vit
from acr_tpu_torch.ops import detect


class Dims(NamedTuple):
    """ViTDet-H's widths and its detector's settings (defaults: the
    published model and HaMeR's demo's thresholds)."""
    patch: int = 16
    width: int = 1280
    depth: int = 32
    heads: int = 16
    mlp: int = 5120
    window: int = 14
    global_blocks: Tuple[int, ...] = (7, 15, 23, 31)
    pretrain_grid: int = 14          # the position table's grid (224 / 16)
    fpn: int = 256
    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    pre_nms: int = 1000
    post_nms: int = 1000
    rpn_nms: float = 0.7
    head_convs: int = 4
    fc: int = 1024
    pooled: int = 7
    classes: int = 80
    cascade: Tuple[Tuple[float, ...], ...] = ((10.0, 10.0, 5.0, 5.0),
                                              (20.0, 20.0, 10.0, 10.0),
                                              (30.0, 30.0, 15.0, 15.0))
    score_thresh: float = 0.25       # HaMeR's demo.py
    test_nms: float = 0.5
    topk: int = 100


DIMS = Dims()
SCALE_CLAMP = math.log(1000.0 / 16)
STRIDES = (4, 8, 16, 32, 64)


def _block_dims(d: Dims) -> vit.Dims:
    return vit.Dims(width=d.width, heads=d.heads, mlp=d.mlp)


class ChannelNorm(nn.Module):
    """detectron2's ``LayerNorm`` over the channels of (N, C, H, W)."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class ConvNorm(nn.Conv2d):
    """A convolution without bias and its channel LayerNorm (``.norm``)."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(cin, cout, k, padding=k // 2, bias=False)
        self.norm = ChannelNorm(cout)

    def forward(self, x):
        return self.norm(super().forward(x))


class Backbone(nn.Module):
    """The plain ViT: a normalised square image (N, 3, S, S) -> the last
    map (N, width, S / 16, S / 16)."""

    def __init__(self, d: Dims, grid: int):
        super().__init__()
        bd = _block_dims(d)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, d.width, d.patch, d.patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, d.pretrain_grid ** 2 + 1,
                                                  d.width))
        # the global blocks' relative positions span the whole grid
        self.blocks = nn.ModuleList([
            vit.Block(bd, window=0, rel_pos=grid) if i in d.global_blocks else
            vit.Block(bd, window=d.window, rel_pos=d.window)
            for i in range(d.depth)])
        self.pretrain_grid = d.pretrain_grid

    def forward(self, x):
        x = self.patch_embed.proj(x)
        n, c, h, w = x.shape
        g = self.pretrain_grid
        pos = self.pos_embed[:, 1:].reshape(1, g, g, c).permute(0, 3, 1, 2)
        pos = F.interpolate(pos, size=(h, w), mode="bicubic", align_corners=False)
        x = (x + pos).flatten(2).transpose(1, 2)
        for blk in self.blocks:
            x = blk(x, (h, w))
        return x.transpose(1, 2).reshape(n, c, h, w)


class Pyramid(nn.Module):
    """The simple feature pyramid over ``net``: p2-p6, each (N, fpn, ...)."""

    def __init__(self, d: Dims, grid: int):
        super().__init__()
        self.net = Backbone(d, grid)
        w, f = d.width, d.fpn
        self.simfp_2 = nn.Sequential(
            nn.ConvTranspose2d(w, w // 2, 2, 2), ChannelNorm(w // 2), nn.GELU(),
            nn.ConvTranspose2d(w // 2, w // 4, 2, 2),
            ConvNorm(w // 4, f, 1), ConvNorm(f, f, 3))
        self.simfp_3 = nn.Sequential(nn.ConvTranspose2d(w, w // 2, 2, 2),
                                     ConvNorm(w // 2, f, 1), ConvNorm(f, f, 3))
        self.simfp_4 = nn.Sequential(ConvNorm(w, f, 1), ConvNorm(f, f, 3))
        self.simfp_5 = nn.Sequential(nn.MaxPool2d(2, 2), ConvNorm(w, f, 1),
                                     ConvNorm(f, f, 3))

    def forward(self, x):
        top = self.net(x)
        p = [self.simfp_2(top), self.simfp_3(top), self.simfp_4(top),
             self.simfp_5(top)]
        return p + [F.max_pool2d(p[-1], 1, 2)]


class RPNHead(nn.Module):
    def __init__(self, d: Dims):
        super().__init__()
        a = len(d.ratios)
        self.conv = nn.Sequential()
        self.conv.add_module("conv0", nn.Conv2d(d.fpn, d.fpn, 3, padding=1))
        self.conv.add_module("conv1", nn.Conv2d(d.fpn, d.fpn, 3, padding=1))
        self.objectness_logits = nn.Conv2d(d.fpn, a, 1)
        self.anchor_deltas = nn.Conv2d(d.fpn, 4 * a, 1)

    def forward(self, x):
        for conv in self.conv:
            x = F.relu(conv(x))
        return self.objectness_logits(x), self.anchor_deltas(x)


class BoxHead(nn.Module):
    """FastRCNNConvFCHead: four 3 x 3 ConvNorm with ReLU, one linear."""

    def __init__(self, d: Dims):
        super().__init__()
        for k in range(d.head_convs):
            self.add_module(f"conv{k + 1}", ConvNorm(d.fpn, d.fpn, 3))
        self.n_convs = d.head_convs
        self.fc1 = nn.Linear(d.fpn * d.pooled * d.pooled, d.fc)

    def forward(self, x):
        for k in range(self.n_convs):
            x = F.relu(getattr(self, f"conv{k + 1}")(x))
        return F.relu(self.fc1(torch.flatten(x, 1)))


class BoxPredictor(nn.Module):
    def __init__(self, d: Dims):
        super().__init__()
        self.cls_score = nn.Linear(d.fc, d.classes + 1)
        self.bbox_pred = nn.Linear(d.fc, 4)

    def forward(self, x):
        return self.cls_score(x), self.bbox_pred(x)


def cell_anchors(d: Dims) -> List[torch.Tensor]:
    """detectron2's ``generate_cell_anchors`` per level: (A, 4)."""
    out = []
    for size in d.anchor_sizes:
        area = size ** 2.0
        rows = []
        for ratio in d.ratios:
            w = math.sqrt(area / ratio)
            h = ratio * w
            rows.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
        out.append(torch.tensor(rows, device="cpu"))
    return out


def grid_anchors(cell: torch.Tensor, stride: int, h: int, w: int,
                 device) -> torch.Tensor:
    """The anchors of an (h, w) level, (h * w * A, 4), location-major."""
    xs = torch.arange(0, w * stride, step=stride, dtype=torch.float32,
                      device=device)
    ys = torch.arange(0, h * stride, step=stride, dtype=torch.float32,
                      device=device)
    sy, sx = torch.meshgrid(ys, xs, indexing="ij")
    sx, sy = sx.reshape(-1), sy.reshape(-1)
    shifts = torch.stack((sx, sy, sx, sy), dim=1)
    return (shifts.view(-1, 1, 4) + cell.to(device).view(1, -1, 4)).reshape(-1, 4)


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights: Tuple[float, ...]) -> torch.Tensor:
    """detectron2's ``Box2BoxTransform.apply_deltas`` for one box per row,
    dw and dh clamped at log(1000 / 16)."""
    widths = boxes[:, 2] - boxes[:, 0]
    heights = boxes[:, 3] - boxes[:, 1]
    ctr_x = boxes[:, 0] + 0.5 * widths
    ctr_y = boxes[:, 1] + 0.5 * heights
    wx, wy, ww, wh = weights
    dx, dy = deltas[:, 0] / wx, deltas[:, 1] / wy
    dw = torch.clamp(deltas[:, 2] / ww, max=SCALE_CLAMP)
    dh = torch.clamp(deltas[:, 3] / wh, max=SCALE_CLAMP)
    px = dx * widths + ctr_x
    py = dy * heights + ctr_y
    pw = torch.exp(dw) * widths
    ph = torch.exp(dh) * heights
    return torch.stack((px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw,
                        py + 0.5 * ph), dim=-1)


def clip(boxes: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    h, w = hw
    return torch.stack((boxes[:, 0].clamp(0, w), boxes[:, 1].clamp(0, h),
                        boxes[:, 2].clamp(0, w), boxes[:, 3].clamp(0, h)), -1)


def _finite_or_zero(boxes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid[:, None], boxes, torch.zeros_like(boxes))


class ViTDet(nn.Module):
    """A normalised, zero-padded square image (1, 3, S, S) whose picture
    fills its top-left (h, w) -> the detections, at fixed shapes:
    ``boxes`` (topk, 4) in input pixels, ``scores`` (topk,), ``classes``
    (topk,) and ``valid`` (topk,), in decreasing score, and ``rois``
    (topk, 4), each detection's first-stage proposal."""

    def __init__(self, dims: Dims = None, size: int = 1024):
        super().__init__()
        self.dims = d = DIMS if dims is None else dims
        self.backbone = Pyramid(d, size // d.patch)
        self.proposal_generator = nn.Module()
        self.proposal_generator.rpn_head = RPNHead(d)
        self.roi_heads = nn.Module()
        self.roi_heads.box_head = nn.ModuleList([BoxHead(d) for _ in d.cascade])
        self.roi_heads.box_predictor = nn.ModuleList(
            [BoxPredictor(d) for _ in d.cascade])
        self._cells = cell_anchors(d)
        self._anchors: Dict[Tuple, List[torch.Tensor]] = {}

    def anchors(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        key = tuple(tuple(f.shape[-2:]) for f in feats) + (feats[0].device,)
        if key not in self._anchors:
            self._anchors[key] = [
                grid_anchors(c, s, f.shape[-2], f.shape[-1], f.device)
                for c, s, f in zip(self._cells, STRIDES, feats)]
        return self._anchors[key]

    def proposals(self, feats: List[torch.Tensor], hw: Tuple[int, int]):
        """RPN over the levels of one image -> (post_nms, 4) boxes in
        decreasing objectness and their validity."""
        d = self.dims
        head = self.proposal_generator.rpn_head
        boxes, scores, valid = [], [], []
        for f, anchors in zip(feats, self.anchors(feats)):
            logits, deltas = head(f)
            a, h, w = logits.shape[1:]
            logits = logits.permute(0, 2, 3, 1).reshape(-1)
            deltas = deltas.view(a, 4, h, w).permute(2, 3, 0, 1).reshape(-1, 4)
            k = min(d.pre_nms, logits.numel())
            sc, idx = logits.topk(k)
            bx = clip(apply_deltas(deltas[idx], anchors[idx], (1.0,) * 4), hw)
            ok = (torch.isfinite(bx).all(1) & torch.isfinite(sc)
                  & (bx[:, 2] - bx[:, 0] > 0) & (bx[:, 3] - bx[:, 1] > 0))
            pad = d.pre_nms - k
            boxes.append(F.pad(_finite_or_zero(bx, ok), (0, 0, 0, pad)))
            scores.append(F.pad(sc, (0, pad), value=-math.inf))
            valid.append(F.pad(ok, (0, pad)))
        boxes, scores, valid = (torch.stack(t) for t in (boxes, scores, valid))
        keep = detect.nms(boxes, valid, d.rpn_nms)
        kept = torch.where(keep, scores, torch.full_like(scores, -math.inf))
        top, idx = kept.reshape(-1).topk(d.post_nms)
        ok = torch.isfinite(top)
        return _finite_or_zero(boxes.reshape(-1, 4)[idx], ok), ok

    def cascade(self, feats: List[torch.Tensor], rois: torch.Tensor,
                valid: torch.Tensor, hw: Tuple[int, int]):
        """The three stages on one image's RoIs -> the class probabilities
        (R, classes + 1), the mean of the stages', and the last stage's
        clipped boxes (R, 4)."""
        d = self.dims
        boxes, probs = rois, []
        for k, weights in enumerate(d.cascade):
            if k:
                boxes = _finite_or_zero(clip(boxes, hw), valid)
            x = detect.roi_align([f[0] for f in feats[:4]], boxes,
                                 detect.assign_levels(boxes), d.pooled,
                                 1.0 / STRIDES[0])
            x = self.roi_heads.box_head[k](x)
            cls, deltas = self.roi_heads.box_predictor[k](x)
            probs.append(F.softmax(cls, -1))
            boxes = apply_deltas(deltas, boxes, weights)
        scores = (probs[0] + probs[1] + probs[2]) * (1.0 / len(probs))
        return scores, clip(boxes, hw)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                stage=contextlib.nullcontext):
        """With ``stage``, a span factory, the eager path's spans
        ``detect.backbone``, ``detect.rpn`` and ``detect.roi``."""
        d = self.dims
        with stage("detect.backbone"):
            feats = self.backbone(x)
        with stage("detect.rpn"):
            rois, valid = self.proposals(feats, hw)
        with stage("detect.roi"):
            probs, boxes = self.cascade(feats, rois, valid, hw)
            r = boxes.shape[0]
            cand = (probs[:, :d.classes] > d.score_thresh) & valid[:, None]
            per_class = torch.where(cand, probs[:, :d.classes],
                                    torch.full_like(probs[:, :d.classes],
                                                    -math.inf)).t()
            sc, order = per_class.sort(dim=1, descending=True, stable=True)
            keep = detect.nms(boxes[order], torch.isfinite(sc), d.test_nms)
            kept = torch.where(keep, sc, torch.full_like(sc, -math.inf))
            top, idx = kept.reshape(-1).topk(min(d.topk, kept.numel()))
            pick = order.reshape(-1)[idx]
            return {"boxes": boxes[pick], "scores": top,
                    "classes": idx // r, "valid": torch.isfinite(top),
                    "rois": rois[pick]}


def init_params(generator: torch.Generator, dims: Dims = None, size: int = 1024,
                device="cpu") -> Dict[str, torch.Tensor]:
    """Seeded stand-in weights: linear weights, position and
    relative-position tables truncated normal of std 0.02, convolutions
    of std 1 / sqrt(fan-in), biases 0, norms 1 and 0."""
    with torch.device("meta"):
        net = ViTDet(dims, size)
    out: Dict[str, torch.Tensor] = {}
    for key, ref in net.state_dict().items():
        t = torch.zeros(ref.shape, dtype=torch.float32, device=device)
        if key.endswith(".weight") and t.dim() == 1:          # the norms
            t.fill_(1.0)
        elif key.endswith((".weight", "pos_embed", "rel_pos_h", "rel_pos_w")):
            std = 0.02
            if t.dim() == 4:
                std = 1.0 / math.sqrt(math.prod(t.shape[1:]))
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        out[key] = t
    return out
