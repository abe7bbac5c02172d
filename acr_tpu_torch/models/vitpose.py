"""ViTPose-H whole-body: each person's 133 COCO-WholeBody keypoints, from
which HaMeR's demo boxes the hands (Xu et al., "ViTPose: Simple Vision
Transformer Baselines for Human Pose Estimation", NeurIPS 2022, arXiv
2204.12484; mmpose's ``ViTPose_huge_wholebody_256x192``).

* Crop (mmpose's ``TopDownGetBboxCenterScale`` and ``TopDownAffine``
  with ``use_udp=True``): the person's box (x1, y1, x2, y2) as x, y, w =
  x2 - x1 + 1, h = y2 - y1 + 1, its centre, widened to the aspect 192:256
  and padded by 1.25 (``center_scale``); the box's corners onto the
  corners of the 256 x 192 crop, ``(size - 1) / (scale * 200)`` pixels a
  pixel (``warp_positions``); ImageNet's mean and std after a division
  by 255.
* Network: ``models.hamer.ViT`` at HaMeR's widths (it is HaMeR's
  backbone class), the 16 x 12 tokens as a map, two ConvT(4, 2, 1)
  without bias to 256 with BatchNorm and ReLU, a 1 x 1 convolution to
  133: 64 x 48 heatmaps.
* Flip test: the mirrored crop's heatmaps, their left and right
  channels swapped (``FLIP_PAIRS``) and mirrored back, averaged with the
  crop's (no shift).
* Decode (``decode``, mmpose's ``keypoints_from_heatmaps`` with
  ``post_process='default'``, ``use_udp=True``): the argmax and its value
  (the confidence), ``post_dark_udp`` with kernel 11 (the heatmaps
  blurred by a Gaussian of sigma 2 with reflected edges, clipped to
  [0.001, 50], their log; one Newton step from the argmax), then the UDP
  back-transform into the frame's pixels.

The names are mmpose's (``backbone.*``, ``keypoint_head.deconv_layers.*``,
``keypoint_head.final_layer``); BatchNorm runs on its running statistics.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from acr_tpu_torch.models import hamer as vit


class Dims(NamedTuple):
    vit: vit.Dims = vit.Dims()
    deconv: int = 256
    keypoints: int = 133
    padding: float = 1.25
    dark_kernel: int = 11


DIMS = Dims()
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LEFT_HAND, RIGHT_HAND = 91, 112            # the first keypoint of each hand


def _face_pairs():
    pairs = [(i, 16 - i) for i in range(8)]
    pairs += [(17 + i, 26 - i) for i in range(5)]
    pairs += [(31, 35), (32, 34), (36, 45), (37, 44), (38, 43), (39, 42),
              (40, 47), (41, 46), (48, 54), (49, 53), (50, 52), (55, 59),
              (56, 58), (60, 64), (61, 63), (65, 67)]
    return [(23 + a, 23 + b) for a, b in pairs]


# COCO-WholeBody's left/right pairs: the body's 8, the feet's 3, the face's
# iBUG-68 mirror, the hands' 21
FLIP_PAIRS = ([(1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14),
               (15, 16), (17, 20), (18, 21), (19, 22)] + _face_pairs()
              + [(LEFT_HAND + i, RIGHT_HAND + i) for i in range(21)])


def flip_order(k: int = 133) -> torch.Tensor:
    perm = list(range(k))
    for a, b in FLIP_PAIRS:
        perm[a], perm[b] = b, a
    return torch.tensor(perm, device="cpu")


class Head(nn.Module):
    def __init__(self, d: Dims):
        super().__init__()
        c = d.deconv
        self.deconv_layers = nn.Sequential(
            nn.ConvTranspose2d(d.vit.width, c, 4, 2, 1, bias=False),
            nn.BatchNorm2d(c), nn.ReLU(inplace=True),
            nn.ConvTranspose2d(c, c, 4, 2, 1, bias=False),
            nn.BatchNorm2d(c), nn.ReLU(inplace=True))
        self.final_layer = nn.Conv2d(c, d.keypoints, 1)

    def forward(self, x):
        return self.final_layer(self.deconv_layers(x))


class ViTPose(nn.Module):
    """Normalised crops (N, 3, crop, crop_w) -> heatmaps (N, 133, crop / 4,
    crop_w / 4), and with ``flip`` the flip test's average."""

    def __init__(self, dims: Dims = None):
        super().__init__()
        self.dims = d = DIMS if dims is None else dims
        self.backbone = vit.ViT(d.vit)
        self.keypoint_head = Head(d)
        self.register_buffer("flip_perm", flip_order(d.keypoints),
                             persistent=False)

    def heatmaps(self, crops):
        d = self.dims.vit
        x = self.backbone(crops)
        n, _, c = x.shape
        x = x.transpose(1, 2).reshape(n, c, d.crop // d.patch,
                                      d.crop_w // d.patch)
        return self.keypoint_head(x)

    def forward(self, crops, flip: bool = True):
        if not flip:
            return self.heatmaps(crops)
        n = crops.shape[0]
        heat = self.heatmaps(torch.cat([crops, crops.flip(-1)]))
        back = heat[n:][:, self.flip_perm].flip(-1)
        return (heat[:n] + back) * 0.5


def center_scale(box: torch.Tensor, d: Dims = DIMS
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boxes (N, 4) x1 y1 x2 y2 -> centre (N, 2) and scale (N, 2), the
    crop's size in units of 200 pixels (mmpose's ``_xyxy2xywh`` and
    ``bbox_xywh2cs``)."""
    x, y = box[:, 0], box[:, 1]
    w = box[:, 2] - box[:, 0] + 1
    h = box[:, 3] - box[:, 1] + 1
    center = torch.stack([x + w * 0.5, y + h * 0.5], -1)
    aspect = d.vit.crop_w / d.vit.crop
    wide = w > aspect * h
    h2 = torch.where(wide, w * 1.0 / aspect, h)
    w2 = torch.where(wide, w, h * aspect)
    return center, torch.stack([w2, h2], -1) / 200.0 * d.padding


def warp_positions(center: torch.Tensor, scale: torch.Tensor, d: Dims = DIMS
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frame positions that the UDP affine samples for each crop row
    (N, crop) and column (N, crop_w)."""
    rows = torch.arange(d.vit.crop, device=center.device, dtype=torch.float32)
    cols = torch.arange(d.vit.crop_w, device=center.device, dtype=torch.float32)
    size = scale * 200.0
    ys = center[:, 1:2] + size[:, 1:2] * (rows[None] / (d.vit.crop - 1.0) - 0.5)
    xs = center[:, 0:1] + size[:, 0:1] * (cols[None] / (d.vit.crop_w - 1.0) - 0.5)
    return ys, xs


def normalise(crops: torch.Tensor) -> torch.Tensor:
    """RGB in 0..255 (N, 3, H, W) -> ImageNet-normalised."""
    return torch.stack([(crops[:, c] / 255.0 - MEAN[c]) / STD[c]
                        for c in range(3)], 1)


def gaussian_blur(heat: torch.Tensor, kernel: int) -> torch.Tensor:
    """cv2's ``GaussianBlur(ksize=kernel, sigma=0)`` with reflected edges
    (BORDER_REFLECT_101) over (N, K, H, W)."""
    sigma = 0.3 * ((kernel - 1) * 0.5 - 1) + 0.8
    r = kernel // 2
    taps = torch.arange(-r, r + 1, dtype=torch.float64, device=heat.device)
    g = torch.exp(-(taps * taps) / (2 * sigma * sigma))
    g = (g / g.sum()).to(heat.dtype)
    n, k, h, w = heat.shape
    x = F.pad(heat.reshape(n * k, 1, h, w), (r, r, r, r), mode="reflect")
    x = F.conv2d(x, g.view(1, 1, -1, 1))
    x = F.conv2d(x, g.view(1, 1, 1, -1))
    return x.reshape(n, k, h, w)


def decode(heat: torch.Tensor, center: torch.Tensor, scale: torch.Tensor,
           kernel: int = 11) -> Dict[str, torch.Tensor]:
    """Heatmaps (N, K, H, W) -> ``keypoints`` (N, K, 2) in the frame's
    pixels, ``confidence`` (N, K) and ``argmax`` (N, K), the flat index of
    each heatmap's maximum. A keypoint whose maximum is not above 0 sits
    at (-1, -1) before its Newton step, as in mmpose; its neighbours are
    read clamped into the padded map (mmpose's flat index wraps into the
    neighbouring map there)."""
    n, k, h, w = heat.shape
    flat = heat.reshape(n, k, h * w)
    idx = flat.argmax(-1)
    conf = torch.gather(flat, 2, idx[..., None])[..., 0]
    preds = torch.stack([idx % w, idx // w], -1).float()
    preds = torch.where((conf > 0.0)[..., None], preds, torch.full_like(preds, -1.0))
    logs = gaussian_blur(heat, kernel).clamp(0.001, 50.0).log()
    pad = F.pad(logs, (1, 1, 1, 1), mode="replicate").reshape(n, k, -1)
    px = (preds[..., 0].long() + 1).clamp(1, w)
    py = (preds[..., 1].long() + 1).clamp(1, h)

    def at(dy, dx):
        return torch.gather(pad, 2, ((py + dy) * (w + 2) + px + dx)[..., None])[..., 0]
    i_, ix1, iy1, ix1y1 = at(0, 0), at(0, 1), at(1, 0), at(1, 1)
    ix1_y1_, ix1_, iy1_ = at(-1, -1), at(0, -1), at(-1, 0)
    dx = 0.5 * (ix1 - ix1_)
    dy = 0.5 * (iy1 - iy1_)
    dxx = ix1 - 2 * i_ + ix1_
    dyy = iy1 - 2 * i_ + iy1_
    dxy = 0.5 * (ix1y1 - ix1 - iy1 + i_ + i_ - ix1_ - iy1_ + ix1_y1_)
    eps = torch.finfo(torch.float32).eps
    a, b, c, e = dxx + eps, dxy, dxy, dyy + eps
    det = a * e - b * c
    step_x = (e * dx - b * dy) / det
    step_y = (a * dy - c * dx) / det
    coords = preds - torch.stack([step_x, step_y], -1)
    size = scale * 200.0
    kx = size[:, 0:1] / (w - 1.0)
    ky = size[:, 1:2] / (h - 1.0)
    x = coords[..., 0] * kx + center[:, 0:1] - size[:, 0:1] * 0.5
    y = coords[..., 1] * ky + center[:, 1:2] - size[:, 1:2] * 0.5
    return {"keypoints": torch.stack([x, y], -1), "confidence": conf,
            "argmax": idx}


def init_params(generator: torch.Generator, dims: Dims = None,
                device="cpu") -> Dict[str, torch.Tensor]:
    """Seeded stand-in weights: HaMeR's ViT initialisers, the head's
    convolutions of std 1 / sqrt(fan-in), biases 0, BatchNorm at unit
    running variance."""
    with torch.device("meta"):
        net = ViTPose(dims)
    out: Dict[str, torch.Tensor] = {}
    for key, ref in net.state_dict().items():
        t = torch.zeros(ref.shape, dtype=torch.float32, device=device)
        if key.endswith("num_batches_tracked"):
            t = torch.zeros(ref.shape, dtype=torch.int64, device=device)
        elif key.endswith("running_var") or (key.endswith(".weight")
                                             and t.dim() == 1):
            t.fill_(1.0)
        elif key.endswith((".weight", "pos_embed")):
            std = 0.02
            if t.dim() == 4:
                std = 1.0 / math.sqrt(math.prod(t.shape[1:]))
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        out[key] = t
    return out
