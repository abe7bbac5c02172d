"""ViTDet-H with cascade box heads (Li et al., ECCV 2022, arXiv
2203.16527; detectron2's ``cascade_mask_rcnn_vitdet_h_75ep`` as HaMeR's
demo runs it) as plain functions over a dict of detectron2's weights.

Plain PyTorch and NumPy in float32, TF32 as the caller sets it
(``judge.fp32_math``), one image at a time and at the sizes the data
gives: no kernel, no graph and no padding of the proposals or
detections to fixed counts. It imports nothing of ``jax``, ``acr_tpu``
or ``acr_tpu_torch``.

- ``preprocess``: the RGB frame resized so that its longer side is 1024
  (``ResizeShortestEdge(1024, max_size=1024)``), bilinear in float32
  with ``align_corners=False`` (departure: detectron2 resizes the uint8
  frame with PIL), normalised by mean (123.675, 116.28, 103.53) and std
  (58.395, 57.12, 57.375), zero-padded at the bottom and right to 1024 x
  1024.
- ``backbone``: the 16 x 16 patch convolution; the (1, 197, 1280)
  position table without its class entry, its 14 x 14 grid resized
  bicubically (``align_corners=False``) to 64 x 64; 32 pre-norm blocks
  (LayerNorm eps 1e-6, qkv with bias, 16 heads of 80, exact GELU), the
  windowed ones on the norm's output zero-padded from 64 to 70 at the
  bottom and right and cut into 25 windows of 14 x 14; attention
  ``softmax((q / sqrt(80)) k^T + rel_h + rel_w) v`` with
  ``rel_h[(i, j), (k, l)] = q[(i, j)] . Rh[i - k + S - 1]``, ``rel_w``
  likewise over the columns, from the unscaled q.
- ``pyramid``: the simple feature pyramid, p2-p6.
- ``rpn``: per level the top min(1000, n) anchors by objectness, their
  boxes decoded (weights 1, dw and dh clamped at log(1000 / 16)),
  clipped to the image, the empty ones dropped, greedy NMS at 0.7 within
  the level (``nms``: an IoU matrix, then a loop); the top 1000 of the
  survivors. ``rpn_levels`` computes every anchor's objectness and
  deltas, ``proposals`` chooses among them.
- ``roi_align``: ROIAlignV2 by explicit bilinear sampling, an adaptive
  ``ceil(size / 7)`` grid of samples per bin, averaged; level ``clamp(
  floor(4 + log2(sqrt(area) / 224 + 1e-8)), 2, 5)``.
- ``cascade``: the three stages, each on the clipped boxes of the stage
  before; the scores the mean of the stages' softmax; the third stage's
  boxes, clipped.
- ``detections``: per class score > 0.25, NMS 0.5, the top 100 by score.

The mask head is left out: the demo never reads its masks.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class Dims(NamedTuple):
    patch: int = 16
    width: int = 1280
    depth: int = 32
    heads: int = 16
    mlp: int = 5120
    window: int = 14
    global_blocks: Tuple[int, ...] = (7, 15, 23, 31)
    pretrain_grid: int = 14
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
    score_thresh: float = 0.25
    test_nms: float = 0.5
    topk: int = 100


DIMS = Dims()
STRIDES = (4, 8, 16, 32, 64)
MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)


def param_shapes(d: Dims = DIMS, size: int = 1024) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every weight's name (detectron2's) and shape."""
    w, f, grid = d.width, d.fpn, size // d.patch
    hd = w // d.heads
    out = [("backbone.net.patch_embed.proj.weight", (w, 3, d.patch, d.patch)),
           ("backbone.net.patch_embed.proj.bias", (w,)),
           ("backbone.net.pos_embed", (1, d.pretrain_grid ** 2 + 1, w))]
    for i in range(d.depth):
        b = f"backbone.net.blocks.{i}."
        side = grid if i in d.global_blocks else d.window
        out += [(b + "norm1.weight", (w,)), (b + "norm1.bias", (w,)),
                (b + "attn.qkv.weight", (3 * w, w)), (b + "attn.qkv.bias", (3 * w,)),
                (b + "attn.proj.weight", (w, w)), (b + "attn.proj.bias", (w,)),
                (b + "attn.rel_pos_h", (2 * side - 1, hd)),
                (b + "attn.rel_pos_w", (2 * side - 1, hd)),
                (b + "norm2.weight", (w,)), (b + "norm2.bias", (w,)),
                (b + "mlp.fc1.weight", (d.mlp, w)), (b + "mlp.fc1.bias", (d.mlp,)),
                (b + "mlp.fc2.weight", (w, d.mlp)), (b + "mlp.fc2.bias", (w,))]

    def conv_norm(name, cin, k):
        return [(name + ".weight", (f, cin, k, k)), (name + ".norm.weight", (f,)),
                (name + ".norm.bias", (f,))]

    def convt(name, cin, cout):
        return [(name + ".weight", (cin, cout, 2, 2)), (name + ".bias", (cout,))]
    out += convt("backbone.simfp_2.0", w, w // 2)
    out += [("backbone.simfp_2.1.weight", (w // 2,)), ("backbone.simfp_2.1.bias", (w // 2,))]
    out += convt("backbone.simfp_2.3", w // 2, w // 4)
    out += conv_norm("backbone.simfp_2.4", w // 4, 1) + conv_norm("backbone.simfp_2.5", f, 3)
    out += convt("backbone.simfp_3.0", w, w // 2)
    out += conv_norm("backbone.simfp_3.1", w // 2, 1) + conv_norm("backbone.simfp_3.2", f, 3)
    out += conv_norm("backbone.simfp_4.0", w, 1) + conv_norm("backbone.simfp_4.1", f, 3)
    out += conv_norm("backbone.simfp_5.1", w, 1) + conv_norm("backbone.simfp_5.2", f, 3)
    a = len(d.ratios)
    r = "proposal_generator.rpn_head."
    out += [(r + "conv.conv0.weight", (f, f, 3, 3)), (r + "conv.conv0.bias", (f,)),
            (r + "conv.conv1.weight", (f, f, 3, 3)), (r + "conv.conv1.bias", (f,)),
            (r + "objectness_logits.weight", (a, f, 1, 1)),
            (r + "objectness_logits.bias", (a,)),
            (r + "anchor_deltas.weight", (4 * a, f, 1, 1)),
            (r + "anchor_deltas.bias", (4 * a,))]
    for k in range(len(d.cascade)):
        h = f"roi_heads.box_head.{k}."
        for c in range(d.head_convs):
            out += conv_norm(f"{h}conv{c + 1}", f, 3)
        out += [(h + "fc1.weight", (d.fc, f * d.pooled ** 2)), (h + "fc1.bias", (d.fc,))]
        p = f"roi_heads.box_predictor.{k}."
        out += [(p + "cls_score.weight", (d.classes + 1, d.fc)),
                (p + "cls_score.bias", (d.classes + 1,)),
                (p + "bbox_pred.weight", (4, d.fc)), (p + "bbox_pred.bias", (4,))]
    return out


def resized_shape(h: int, w: int, size: int) -> Tuple[int, int]:
    """``ResizeShortestEdge.get_output_shape(h, w, size, size)``."""
    scale = size * 1.0 / min(h, w)
    newh, neww = (size * 1.0, scale * w) if h < w else (scale * h, size * 1.0)
    if max(newh, neww) > size:
        scale = size * 1.0 / max(newh, neww)
        newh, neww = newh * scale, neww * scale
    return int(newh + 0.5), int(neww + 0.5)


def resize(rgb: torch.Tensor, size: int) -> torch.Tensor:
    """RGB uint8 (H, W, 3) -> float (3, h, w) in 0..255, bilinear."""
    hw = resized_shape(rgb.shape[0], rgb.shape[1], size)
    x = rgb.permute(2, 0, 1)[None].float()
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False)[0]


def preprocess(resized: torch.Tensor, size: int) -> torch.Tensor:
    """(3, h, w) in 0..255 -> the normalised, padded (1, 3, size, size)."""
    x = torch.zeros((1, 3, size, size), device=resized.device)
    for c in range(3):
        x[0, c, :resized.shape[1], :resized.shape[2]] = (resized[c] - MEAN[c]) / STD[c]
    return x


def _ln(x, w, name, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w[name + ".weight"] + w[name + ".bias"]


def _cln(x, w, name, eps=1e-6):
    """LayerNorm over the channels of (N, C, H, W)."""
    mu = x.mean(1, keepdim=True)
    var = ((x - mu) ** 2).mean(1, keepdim=True)
    return ((x - mu) / torch.sqrt(var + eps) * w[name + ".weight"][:, None, None]
            + w[name + ".bias"][:, None, None])


def _linear(x, w, name):
    return x @ w[name + ".weight"].T + w[name + ".bias"]


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _conv_norm(x, w, name):
    k = w[name + ".weight"].shape[-1]
    return _cln(F.conv2d(x, w[name + ".weight"], padding=k // 2), w, name + ".norm")


def _rel(table: torch.Tensor, side: int) -> torch.Tensor:
    """(2 side - 1, C) -> R (side, side, C), R[i, k] = table[i - k + side - 1]."""
    i = torch.arange(side, device=table.device)
    return table[i[:, None] - i[None, :] + side - 1]


def attention(x: torch.Tensor, w, b: str, heads: int) -> torch.Tensor:
    """x (N, S, S, C) -> (N, S, S, C): self-attention over the S x S grid
    with decomposed relative positions."""
    n, s, _, c = x.shape
    hd = c // heads
    qkv = _linear(x.reshape(n, s * s, c), w, b + "qkv")
    q, k, v = (t.reshape(n, s * s, heads, hd).transpose(1, 2) for t in qkv.chunk(3, -1))
    attn = (q * hd ** -0.5) @ k.transpose(-1, -2)
    rh, rw = _rel(w[b + "rel_pos_h"], s), _rel(w[b + "rel_pos_w"], s)
    rq = q.reshape(n, heads, s, s, hd)
    rel_h = torch.einsum("nhyxc,ykc->nhyxk", rq, rh)
    rel_w = torch.einsum("nhyxc,xkc->nhyxk", rq, rw)
    attn = (attn.reshape(n, heads, s, s, s, s) + rel_h[..., :, None]
            + rel_w[..., None, :]).reshape(n, heads, s * s, s * s)
    out = torch.softmax(attn, -1) @ v
    out = out.transpose(1, 2).reshape(n, s, s, c)
    return _linear(out, w, b + "proj")


def backbone(w, x: torch.Tensor, d: Dims = DIMS) -> torch.Tensor:
    """The normalised image (1, 3, S, S) -> the last map (1, width, S/16, S/16)."""
    p = "backbone.net."
    x = F.conv2d(x, w[p + "patch_embed.proj.weight"], w[p + "patch_embed.proj.bias"],
                 stride=d.patch)
    _, c, h, wd = x.shape
    g = d.pretrain_grid
    pos = w[p + "pos_embed"][:, 1:].reshape(1, g, g, c).permute(0, 3, 1, 2)
    pos = F.interpolate(pos, size=(h, wd), mode="bicubic", align_corners=False)
    x = (x + pos).permute(0, 2, 3, 1)                       # (1, h, w, C)
    for i in range(d.depth):
        b = f"{p}blocks.{i}."
        y = _ln(x, w, b + "norm1")
        if i in d.global_blocks:
            y = attention(y, w, b + "attn.", d.heads)
        else:
            s = d.window
            ph, pw = (s - h % s) % s, (s - wd % s) % s
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
            gh, gw = (h + ph) // s, (wd + pw) // s
            win = y.reshape(1, gh, s, gw, s, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, s, s, c)
            win = attention(win, w, b + "attn.", d.heads)
            y = win.reshape(1, gh, gw, s, s, c).permute(0, 1, 3, 2, 4, 5)
            y = y.reshape(1, h + ph, wd + pw, c)[:, :h, :wd]
        x = x + y
        x = x + _linear(_gelu(_linear(_ln(x, w, b + "norm2"), w, b + "mlp.fc1")),
                        w, b + "mlp.fc2")
    return x.permute(0, 3, 1, 2)


def pyramid(w, top: torch.Tensor) -> List[torch.Tensor]:
    """The last map -> p2, p3, p4, p5, p6."""
    def convt(x, name):
        return F.conv_transpose2d(x, w[name + ".weight"], w[name + ".bias"], stride=2)

    def tail(x, a, b):
        return _conv_norm(_conv_norm(x, w, a), w, b)
    s = "backbone.simfp_"
    p2 = convt(_gelu(_cln(convt(top, s + "2.0"), w, s + "2.1")), s + "2.3")
    p2 = tail(p2, s + "2.4", s + "2.5")
    p3 = tail(convt(top, s + "3.0"), s + "3.1", s + "3.2")
    p4 = tail(top, s + "4.0", s + "4.1")
    p5 = tail(F.max_pool2d(top, 2, 2), s + "5.1", s + "5.2")
    return [p2, p3, p4, p5, F.max_pool2d(p5, 1, 2)]


def anchors(d: Dims, stride: int, size: int, h: int, w: int, device) -> torch.Tensor:
    """The level's anchors (h * w * A, 4): each location's A anchors, the
    locations in row-major order, centred on (x * stride, y * stride)."""
    cells = []
    for ratio in d.ratios:
        aw = math.sqrt(size ** 2.0 / ratio)
        ah = ratio * aw
        cells.append([-aw / 2.0, -ah / 2.0, aw / 2.0, ah / 2.0])
    cells = torch.tensor(cells, device=device)
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32) * stride,
                            torch.arange(w, device=device, dtype=torch.float32) * stride,
                            indexing="ij")
    shift = torch.stack([xs, ys, xs, ys], -1).reshape(-1, 1, 4)
    return (shift + cells[None]).reshape(-1, 4)


def decode(deltas: torch.Tensor, boxes: torch.Tensor, weights) -> torch.Tensor:
    """Box deltas (N, 4) on boxes (N, 4) -> boxes (N, 4)."""
    wd, ht = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]
    cx, cy = boxes[:, 0] + 0.5 * wd, boxes[:, 1] + 0.5 * ht
    clamp = math.log(1000.0 / 16)
    dx, dy = deltas[:, 0] / weights[0], deltas[:, 1] / weights[1]
    dw = (deltas[:, 2] / weights[2]).clamp(max=clamp)
    dh = (deltas[:, 3] / weights[3]).clamp(max=clamp)
    px, py = dx * wd + cx, dy * ht + cy
    pw, ph = torch.exp(dw) * wd, torch.exp(dh) * ht
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw, py + 0.5 * ph], -1)


def clip(boxes: torch.Tensor, hw) -> torch.Tensor:
    h, w = hw
    return torch.stack([boxes[:, 0].clamp(0, w), boxes[:, 1].clamp(0, h),
                        boxes[:, 2].clamp(0, w), boxes[:, 3].clamp(0, h)], -1)


def iou(boxes: torch.Tensor) -> np.ndarray:
    """Pairwise IoU (N, N), as torchvision's NMS computes it."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    w = (torch.minimum(x2[:, None], x2[None]) - torch.maximum(x1[:, None], x1[None])).clamp(min=0)
    h = (torch.minimum(y2[:, None], y2[None]) - torch.maximum(y1[:, None], y1[None])).clamp(min=0)
    inter = w * h
    return (inter / (area[:, None] + area[None] - inter)).cpu().numpy()


def nms(boxes: torch.Tensor, thresh) -> List[int]:
    """Greedy NMS over boxes in decreasing score order: the kept indices.
    ``thresh``: the IoU above which a kept box suppresses a later one, or
    per box (N,) the IoU above which that box is suppressed."""
    over = iou(boxes) > thresh
    gone = np.zeros(len(over), bool)
    keep = []
    for i in range(len(over)):
        if gone[i]:
            continue
        keep.append(i)
        gone[i + 1:] |= over[i, i + 1:]
    return keep


def rpn_levels(w, feats: List[torch.Tensor], d: Dims
               ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Per level, every anchor's objectness (N,), deltas (N, 4) and box
    (N, 4), in ``anchors``' order."""
    r = "proposal_generator.rpn_head."
    out = []
    for f, size, stride in zip(feats, d.anchor_sizes, STRIDES):
        x = f
        for k in range(2):
            x = F.relu(F.conv2d(x, w[f"{r}conv.conv{k}.weight"],
                                w[f"{r}conv.conv{k}.bias"], padding=1))
        logits = F.conv2d(x, w[r + "objectness_logits.weight"], w[r + "objectness_logits.bias"])
        deltas = F.conv2d(x, w[r + "anchor_deltas.weight"], w[r + "anchor_deltas.bias"])
        a, h, wd = logits.shape[1:]
        out.append((logits[0].permute(1, 2, 0).reshape(-1),
                    deltas[0].reshape(a, 4, h, wd).permute(2, 3, 0, 1).reshape(-1, 4),
                    anchors(d, stride, size, h, wd, f.device)))
    return out


def rpn(w, feats: List[torch.Tensor], d: Dims, hw) -> Tuple[torch.Tensor, torch.Tensor]:
    """The proposals (R, 4) and their objectness (R,), R <= post_nms, in
    decreasing objectness."""
    return proposals(rpn_levels(w, feats, d), d, hw)


def proposals(levels, d: Dims, hw, boost=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rpn`` over ``rpn_levels``' outputs. ``boost`` (level, anchor,
    objectness, iou) raises one anchor's objectness by ``objectness`` and
    the IoU above which the NMS suppresses its box by ``iou``, as a judge
    asks whether a proposal is kept within gaps of those choices."""
    boxes, scores = [], []
    for lv, (logits, deltas, anc) in enumerate(levels):
        if boost is not None and boost[0] == lv:
            logits = logits.clone()
            logits[boost[1]] += boost[2]
        order = torch.argsort(logits, descending=True, stable=True)[:min(d.pre_nms, len(logits))]
        bx = clip(decode(deltas[order], anc[order], (1.0, 1.0, 1.0, 1.0)), hw)
        sc = logits[order]
        ok = (torch.isfinite(bx).all(1) & torch.isfinite(sc)
              & (bx[:, 2] > bx[:, 0]) & (bx[:, 3] > bx[:, 1]))
        bx, sc = bx[ok], sc[ok]
        thresh = d.rpn_nms
        if boost is not None and boost[0] == lv:
            thresh = np.full(len(bx), d.rpn_nms, np.float32)
            thresh[(order[ok] == boost[1]).cpu().numpy()] += boost[3]
        keep = nms(bx, thresh)
        boxes.append(bx[keep])
        scores.append(sc[keep])
    boxes, scores = torch.cat(boxes), torch.cat(scores)
    order = torch.argsort(scores, descending=True, stable=True)[:d.post_nms]
    return boxes[order], scores[order]


def roi_align(feats: List[torch.Tensor], boxes: torch.Tensor, pooled: int,
              chunk: int = 128) -> torch.Tensor:
    """ROIAlignV2 of boxes (R, 4) over p2-p5 -> (R, C, pooled, pooled):
    the RoIs that share a level and a sampling grid sampled together."""
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    level = (torch.floor(4 + torch.log2(torch.sqrt(area) / 224 + 1e-8)).clamp(2, 5) - 2).long()
    scale = 1.0 / torch.tensor(STRIDES[:4], device=boxes.device, dtype=torch.float32)
    b = boxes * scale[level][:, None] - 0.5
    bh, bw = (b[:, 3] - b[:, 1]) / pooled, (b[:, 2] - b[:, 0]) / pooled
    gh, gw = torch.ceil(bh).long(), torch.ceil(bw).long()
    c = feats[0].shape[1]
    out = torch.zeros((len(boxes), c, pooled, pooled), device=boxes.device)
    keys = torch.stack([level, gh, gw], 1).cpu().numpy()
    cells = torch.arange(pooled, device=boxes.device, dtype=torch.float32)
    for lv, g_h, g_w in {tuple(k) for k in keys.tolist()}:
        if g_h <= 0 or g_w <= 0:
            continue
        sel = torch.as_tensor(np.nonzero((keys == (lv, g_h, g_w)).all(1))[0],
                              device=boxes.device)
        f = feats[lv][0]
        sy = (torch.arange(g_h, device=f.device) + 0.5) / g_h
        sx = (torch.arange(g_w, device=f.device) + 0.5) / g_w
        for at in range(0, len(sel), chunk):
            s = sel[at:at + chunk]
            ys = b[s, 1, None, None] + (cells[:, None] + sy[None]) * bh[s, None, None]
            xs = b[s, 0, None, None] + (cells[:, None] + sx[None]) * bw[s, None, None]
            vals = _bilinear(f, ys.reshape(len(s), -1), xs.reshape(len(s), -1))
            out[s] = vals.reshape(len(s), c, pooled, g_h, pooled, g_w).mean((3, 5))
    return out


def _bilinear(f: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """torchvision's ``bilinear_interpolate`` of f (C, H, W) on each RoI's
    grid ys (N, Ly) x xs (N, Lx) -> (N, C, Ly, Lx): zero beyond one pixel
    outside, the last row and column held."""
    h, w = f.shape[1:]

    def axis(p, n):
        out = (p < -1.0) | (p > n)
        p = p.clamp(min=0)
        lo = torch.floor(p).long()
        top = lo >= n - 1
        lo = torch.where(top, torch.full_like(lo, n - 1), lo)
        hi = torch.where(top, lo, lo + 1)
        frac = torch.where(top, torch.zeros_like(p), p - lo.float())
        return lo, hi, frac, out
    y0, y1, fy, oy = axis(ys, h)
    x0, x1, fx, ox = axis(xs, w)
    fy, fx = fy[:, None, :, None], fx[:, None, None, :]

    def at(yy, xx):
        return f[:, yy[:, :, None], xx[:, None, :]].transpose(0, 1)
    v = ((1 - fy) * (1 - fx) * at(y0, x0) + (1 - fy) * fx * at(y0, x1)
         + fy * (1 - fx) * at(y1, x0) + fy * fx * at(y1, x1))
    return v * (~(oy[:, :, None] | ox[:, None, :])).float()[:, None]


def box_head(w, x: torch.Tensor, k: int, d: Dims) -> torch.Tensor:
    h = f"roi_heads.box_head.{k}."
    for c in range(d.head_convs):
        x = F.relu(_conv_norm(x, w, f"{h}conv{c + 1}"))
    return F.relu(_linear(x.flatten(1), w, h + "fc1"))


def cascade(w, feats, rois: torch.Tensor, d: Dims, hw):
    """(probabilities (R, classes + 1), the mean of the stages', the last
    stage's clipped boxes (R, 4))."""
    boxes, probs = rois, []
    for k, weights in enumerate(d.cascade):
        if k:
            boxes = clip(boxes, hw)
        x = box_head(w, roi_align(feats[:4], boxes, d.pooled), k, d)
        p = f"roi_heads.box_predictor.{k}."
        probs.append(torch.softmax(_linear(x, w, p + "cls_score"), -1))
        boxes = decode(_linear(x, w, p + "bbox_pred"), boxes, weights)
    return sum(probs) / len(probs), clip(boxes, hw)


def detections(probs: torch.Tensor, boxes: torch.Tensor, d: Dims):
    """Per class score > thresh, NMS, the top ``topk``: a list of (score,
    class, RoI index), in decreasing score."""
    out = []
    for c in range(d.classes):
        idx = torch.nonzero(probs[:, c] > d.score_thresh)[:, 0]
        if not len(idx):
            continue
        idx = idx[torch.argsort(probs[idx, c], descending=True, stable=True)]
        for k in nms(boxes[idx], d.test_nms):
            out.append((float(probs[idx[k], c]), c, int(idx[k])))
    out.sort(key=lambda t: -t[0])
    return out[:d.topk]


def detect(w, rgb: torch.Tensor, size: int, d: Dims = DIMS) -> Dict:
    """One RGB frame (H, W, 3) uint8 -> the resized frame, the RoIs, their
    objectness, scores and final boxes, and the detections (score, class,
    RoI); with the pyramid and ``rpn_levels``' outputs, for ``redetect``."""
    resized = resize(rgb, size)
    feats = pyramid(w, backbone(w, preprocess(resized, size), d))
    levels = rpn_levels(w, feats, d)
    return redetect(w, {"resized": resized, "feats": feats, "levels": levels}, d)


def redetect(w, det: Dict, d: Dims = DIMS, boost=None) -> Dict:
    """``det`` with its proposals chosen anew (``proposals``' ``boost``)
    and the cascade and detections on them."""
    hw = tuple(det["resized"].shape[1:])
    rois, objectness = proposals(det["levels"], d, hw, boost)
    probs, boxes = cascade(w, det["feats"], rois, d, hw)
    return dict(det, rois=rois, objectness=objectness, probs=probs, boxes=boxes,
                detections=detections(probs, boxes, d))
