"""The detector's NMS and ROIAlignV2 (``csrc/detect.cu``), each with its
plain PyTorch version.

Neither replaces a Pallas kernel (the JAX package has no detector). They
let ViTDet's proposals and cascade heads (``models/vitdet.py``) run at
fixed shapes on the card without a host wait, inside the detect stage's
CUDA graph: torchvision, whose ``nms`` and ``roi_align`` detectron2
calls, is not installed on either host, and its ``nms`` reads its
bitmask back on the host.

- ``nms(boxes, valid, thresh)``: greedy NMS within each segment (a level
  of the RPN, a class of the box head) of boxes given in the order of
  decreasing score; invalid boxes are never kept and suppress nothing.
  The keep flags come back in the given order, at the given shape.
- ``roi_align(features, rois, level, pooled, scale0)``: ROIAlignV2
  (``aligned=True``, adaptive sampling ``ceil(size / pooled)``), each RoI
  from the level ``assign_levels`` gives it.

On a CUDA tensor the wrappers launch the kernel, on a CPU tensor they run
the plain version; the plain versions repeat the kernels' arithmetic
operation by operation (in float32, each product and sum rounded on its
own, as ``--fmad=false`` builds the kernels), so the two agree bit for
bit. ``LAUNCHES`` counts the kernel launches, on the host, with no sync.
``nms_work`` and ``roi_align_work`` give a launch's least work, the
bound that ``chip_smoke.py`` times the kernels against.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

# kernel launches: "nms" and "roi_align"; a replay of a graph that holds
# them advances these by the launches it holds (pipeline.graphs)
LAUNCHES: Dict[str, int] = {"nms": 0, "roi_align": 0}

CANONICAL_SIZE = 224.0
CANONICAL_LEVEL = 4


def nms_plain(boxes: torch.Tensor, valid: torch.Tensor, thresh: float
              ) -> torch.Tensor:
    """``nms``'s arithmetic in plain PyTorch: boxes (S, N, 4), valid (S,
    N) bool -> keep (S, N) bool."""
    s, n, _ = boxes.shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    gone = ~valid.clone()
    later = torch.arange(n, device=boxes.device)
    for i in range(n):
        w = torch.clamp_min(torch.minimum(x2[:, i:i + 1], x2)
                            - torch.maximum(x1[:, i:i + 1], x1), 0.0)
        h = torch.clamp_min(torch.minimum(y2[:, i:i + 1], y2)
                            - torch.maximum(y1[:, i:i + 1], y1), 0.0)
        inter = w * h
        ovr = inter / (area[:, i:i + 1] + area - inter)
        gone |= (~gone[:, i:i + 1]) & (later > i)[None] & (ovr > thresh)
    return ~gone


def nms(boxes: torch.Tensor, valid: torch.Tensor, thresh: float
        ) -> torch.Tensor:
    """Greedy NMS per segment: boxes (S, N, 4) x1 y1 x2 y2 in decreasing
    score order, valid (S, N) bool -> keep (S, N) bool (IoU > ``thresh``
    suppresses, as torchvision's ``nms``)."""
    if not boxes.is_cuda:
        return nms_plain(boxes, valid, thresh)
    from acr_tpu_torch.ops import cuda_lib
    s, n, _ = boxes.shape
    dev = boxes.device
    boxes = boxes.float().contiguous()
    flags = valid.to(torch.uint8).contiguous()
    cuda_lib.check("boxes", boxes, torch.float32, (s, n, 4), dev)
    keep = torch.empty((s, n), dtype=torch.uint8, device=dev)
    cuda_lib.launch(cuda_lib.library().acr_nms, dev, boxes.data_ptr(),
                    flags.data_ptr(), float(thresh), s, n, keep.data_ptr())
    LAUNCHES["nms"] += 1
    return keep.bool()


def assign_levels(boxes: torch.Tensor, n_levels: int = 4) -> torch.Tensor:
    """detectron2's ``assign_boxes_to_levels`` over p2-p5: ``clamp(floor(4
    + log2(sqrt(area) / 224 + 1e-8)), 2, 5) - 2`` as int32."""
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    lvl = torch.floor(CANONICAL_LEVEL + torch.log2(
        torch.sqrt(area) / CANONICAL_SIZE + 1e-8))
    return (torch.clamp(lvl, 2, 1 + n_levels) - 2).to(torch.int32)


def _bilinear(f: torch.Tensor, y: torch.Tensor, x: torch.Tensor
              ) -> torch.Tensor:
    """The kernel's ``bilinear`` over f (C, H, W) at y (R, P, 1), x (R, 1,
    P) -> (R, C, P, P), zero outside [-1, size]."""
    _, h, w = f.shape
    y, x = torch.broadcast_tensors(y, x)
    out = (y < -1.0) | (y > float(h)) | (x < -1.0) | (x > float(w))
    y = torch.where(y <= 0, torch.zeros_like(y), y)
    x = torch.where(x <= 0, torch.zeros_like(x), x)
    yl, xl = y.long(), x.long()
    ytop, xtop = yl >= h - 1, xl >= w - 1
    yl = torch.where(ytop, torch.full_like(yl, h - 1), yl)
    xl = torch.where(xtop, torch.full_like(xl, w - 1), xl)
    yh = torch.where(ytop, yl, yl + 1)
    xh = torch.where(xtop, xl, xl + 1)
    y = torch.where(ytop, yl.float(), y)
    x = torch.where(xtop, xl.float(), x)
    ly, lx = y - yl.float(), x - xl.float()
    hy, hx = 1.0 - ly, 1.0 - lx

    def at(yy, xx):           # (R, C, P, P); indices of masked samples clamped
        return f[:, yy.clamp(0, h - 1), xx.clamp(0, w - 1)].permute(1, 0, 2, 3)
    val = (((hy * hx)[:, None] * at(yl, xl) + (hy * lx)[:, None] * at(yl, xh))
           + (ly * hx)[:, None] * at(yh, xl)) + (ly * lx)[:, None] * at(yh, xh)
    return torch.where(out[:, None], torch.zeros_like(val), val)


def roi_align_plain(features: Sequence[torch.Tensor], rois: torch.Tensor,
                    level: torch.Tensor, pooled: int, scale0: float
                    ) -> torch.Tensor:
    """``roi_align``'s arithmetic in plain PyTorch, sample by sample in the
    kernel's order."""
    r = rois.shape[0]
    c = features[0].shape[0]
    out = rois.new_zeros((r, c, pooled, pooled))
    ph = torch.arange(pooled, device=rois.device, dtype=torch.float32)
    for lv, f in enumerate(features):
        sel = (level == lv).nonzero()[:, 0]
        if not len(sel):
            continue
        scale = scale0 / float(1 << lv)
        x1, y1, x2, y2 = (rois[sel, k] * scale - 0.5 for k in range(4))
        rw, rh = x2 - x1, y2 - y1
        # divisions by a tensor: CUDA divides by a scalar as a product
        # with its reciprocal, which the kernel's division does not round as
        p = torch.full_like(rw, float(pooled))
        bw, bh = rw / p, rh / p
        gw, gh = torch.ceil(rw / p).long(), torch.ceil(rh / p).long()
        acc = rois.new_zeros((len(sel), c, pooled, pooled))
        for iy in range(max(int(gh.max()), 0)):
            y = y1[:, None] + ph[None] * bh[:, None] + \
                ((iy + 0.5) * bh / gh.float())[:, None]
            for ix in range(max(int(gw.max()), 0)):
                x = x1[:, None] + ph[None] * bw[:, None] + \
                    ((ix + 0.5) * bw / gw.float())[:, None]
                val = _bilinear(f, y[:, :, None], x[:, None, :])
                live = ((iy < gh) & (ix < gw))[:, None, None, None]
                acc = acc + torch.where(live, val, torch.zeros_like(val))
        count = torch.clamp_min(gh * gw, 1).float()
        out[sel] = acc / count[:, None, None, None]
    return out


def roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor,
              level: torch.Tensor, pooled: int = 7, scale0: float = 0.25
              ) -> torch.Tensor:
    """ROIAlignV2 of one image: features, the levels (C, H >> l, W >> l)
    at scales ``scale0 / 2**l``; rois (R, 4) x1 y1 x2 y2 in input pixels;
    level (R,) int32 in 0..3 -> (R, C, pooled, pooled)."""
    if not rois.is_cuda:
        return roi_align_plain(features, rois, level, pooled, scale0)
    from acr_tpu_torch.ops import cuda_lib
    dev = rois.device
    c, h, w = features[0].shape
    for lv, f in enumerate(features):
        cuda_lib.check(f"level {lv}", f, torch.float32, (c, h >> lv, w >> lv), dev)
    r = rois.shape[0]
    rois = rois.float().contiguous()
    level = level.to(torch.int32).contiguous()
    out = torch.empty((r, c, pooled, pooled), dtype=torch.float32, device=dev)
    ptrs = [f.data_ptr() for f in features] + \
        [features[-1].data_ptr()] * (4 - len(features))
    cuda_lib.launch(cuda_lib.library().acr_roi_align, dev, *ptrs, c, h, w,
                    float(scale0), rois.data_ptr(), level.data_ptr(), r,
                    pooled, out.data_ptr())
    LAUNCHES["roi_align"] += 1
    return out


def nms_work(segments: int, n: int) -> Tuple[int, float]:
    """(bytes, operations) of one ``nms`` launch at its least: the boxes
    and flags read and the keep flags written once; every pair's IoU
    (about 14 operations), as a parallel bitmask NMS computes them."""
    return segments * n * (16 + 1 + 1), 14.0 * segments * n * (n - 1) / 2


def roi_align_work(rois: int, channels: int, pooled: int = 7) -> Tuple[int, float]:
    """(bytes, operations) of one ``roi_align`` launch at its least: the
    output written once and, per output, one bilinear sample (4 loads, 10
    operations)."""
    outs = rois * channels * pooled * pooled
    return 4 * outs, 10.0 * outs
