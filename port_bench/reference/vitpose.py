"""ViTPose-H whole-body (Xu et al., NeurIPS 2022, arXiv 2204.12484;
mmpose's ``ViTPose_huge_wholebody_256x192`` as HaMeR's demo runs it) and
the demo's hand boxes, as plain functions over a dict of mmpose's
weights.

Plain PyTorch and NumPy: the network in float32 with TF32 as the caller
sets it, the crop's geometry and the decode in float64. It imports
nothing of ``jax``, ``acr_tpu`` or ``acr_tpu_torch``; the ViT is
``reference/hamer.py``'s, which is HaMeR's backbone class.

- ``center_scale``: mmpose's ``_xyxy2xywh`` (w = x2 - x1 + 1) and
  ``bbox_xywh2cs`` at the aspect 192:256 and padding 1.25.
- ``crop``: ``TopDownAffine(use_udp=True)``: crop pixel (u, v) reads the
  frame at ``centre + (u / 191 - 0.5, v / 255 - 0.5) * scale * 200``,
  bilinear, zero outside; departure: the frame is the one the detector
  resized to 1024 px (read at the frame position times its scale) and
  the position is exact, where mmpose warps the camera frame with cv2's
  1/32-pixel positions. Then ToTensor and ImageNet's mean and std.
- ``heatmaps``: the ViT, the 16 x 12 tokens as a map, two ConvT(4, 2, 1)
  with BatchNorm (running statistics, eps 1e-5) and ReLU, a 1 x 1
  convolution to 133; with ``flip`` the mirrored crop's maps, their
  COCO-WholeBody pairs swapped and mirrored back, averaged.
- ``decode``: ``keypoints_from_heatmaps`` with ``use_udp=True``: the
  argmax and its value, ``post_dark_udp`` (cv2's Gaussian blur of kernel
  11 and sigma 2 with reflected edges, clip to [0.001, 50], log, edge
  padding, one Newton step with ``inv(H + eps I)``), ``transform_preds``
  with UDP. Departure: a keypoint whose maximum is not above 0 reads its
  neighbours clamped into the padded map, where mmpose's flat index
  wraps into the neighbouring map; such a keypoint is never valid.
- ``hand_boxes``: the demo's rule, keypoints 91-111 (left) and 112-132
  (right), valid above 0.5, a hand detected with more than 3; the min /
  max box of its valid keypoints, then HaMeR's ``rescale_factor`` 2 and
  aspect 192:256 (``reference/hamer.py``'s ``expand_to_aspect_ratio``).
- ``hand_crop``: ``reference/hamer.py``'s ``crop`` with its anti-alias
  blur held to a radius of ``BLUR_RADIUS`` (departure, as the
  configuration assumes of the program; reached only by boxes over 8576
  px, which the scene's outlying keypoints make).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import hamer


class Dims(NamedTuple):
    vit: hamer.Dims = hamer.Dims()
    deconv: int = 256
    keypoints: int = 133
    padding: float = 1.25
    dark_kernel: int = 11


DIMS = Dims()
MEAN = np.array([0.485, 0.456, 0.406])
STD = np.array([0.229, 0.224, 0.225])
LEFT, RIGHT = 91, 112
KP_CONF = 0.5
MIN_VALID = 3
BLUR_RADIUS = 32


def flip_pairs() -> List[Tuple[int, int]]:
    """COCO-WholeBody's left/right keypoint pairs."""
    face = [(i, 16 - i) for i in range(8)] + [(17 + i, 26 - i) for i in range(5)]
    face += [(31, 35), (32, 34), (36, 45), (37, 44), (38, 43), (39, 42), (40, 47),
             (41, 46), (48, 54), (49, 53), (50, 52), (55, 59), (56, 58), (60, 64),
             (61, 63), (65, 67)]
    return ([(1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16),
             (17, 20), (18, 21), (19, 22)] + [(23 + a, 23 + b) for a, b in face]
            + [(LEFT + i, RIGHT + i) for i in range(21)])


def param_shapes(d: Dims = DIMS) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every weight's name (mmpose's) and shape."""
    out = [(n, s) for n, s in hamer.param_shapes(d.vit) if n.startswith("backbone.")]
    c = d.deconv
    h = "keypoint_head."
    for i, cin in ((0, d.vit.width), (3, c)):
        out.append((f"{h}deconv_layers.{i}.weight", (cin, c, 4, 4)))
        out += [(f"{h}deconv_layers.{i + 1}.{k}", (c,))
                for k in ("weight", "bias", "running_mean", "running_var")]
    return out + [(h + "final_layer.weight", (d.keypoints, c, 1, 1)),
                  (h + "final_layer.bias", (d.keypoints,))]


def center_scale(box, d: Dims = DIMS) -> Tuple[np.ndarray, np.ndarray]:
    """A box (x1, y1, x2, y2) -> the crop's centre and its size / 200."""
    x1, y1, x2, y2 = (float(v) for v in box)
    w, h = x2 - x1 + 1, y2 - y1 + 1
    center = np.array([x1 + w * 0.5, y1 + h * 0.5])
    aspect = d.vit.crop_w / d.vit.crop
    if w > aspect * h:
        h = w * 1.0 / aspect
    elif w < aspect * h:
        w = h * aspect
    return center, np.array([w, h]) / 200.0 * d.padding


def crop(resized: torch.Tensor, center, scale, frame_per_px, d: Dims = DIMS
         ) -> torch.Tensor:
    """The resized frame (3, h, w) in 0..255 and the crop's centre and
    scale in frame pixels (``frame_per_px`` (sx, sy) frame pixels a
    resized pixel) -> the normalised crop (3, crop, crop_w), float32."""
    dev = resized.device
    size = np.asarray(scale) * 200.0
    v = torch.arange(d.vit.crop, dtype=torch.float64, device=dev)
    u = torch.arange(d.vit.crop_w, dtype=torch.float64, device=dev)
    ys = (center[1] + size[1] * (v / (d.vit.crop - 1.0) - 0.5)) / frame_per_px[1]
    xs = (center[0] + size[0] * (u / (d.vit.crop_w - 1.0) - 0.5)) / frame_per_px[0]
    img = resized.double()
    h, w = img.shape[1:]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None]
    y0, x0 = y0.long(), x0.long()

    def px(yy, xx):
        ok = ((yy >= 0) & (yy < h))[:, None] & ((xx >= 0) & (xx < w))[None]
        return img[:, yy.clamp(0, h - 1)][:, :, xx.clamp(0, w - 1)] * ok
    out = ((1 - fy) * (1 - fx) * px(y0, x0) + (1 - fy) * fx * px(y0, x0 + 1)
           + fy * (1 - fx) * px(y0 + 1, x0) + fy * fx * px(y0 + 1, x0 + 1))
    mean = torch.as_tensor(MEAN, device=dev)[:, None, None]
    std = torch.as_tensor(STD, device=dev)[:, None, None]
    return ((out / 255.0 - mean) / std).float()


def heatmaps(w, crops: torch.Tensor, d: Dims = DIMS, flip: bool = True) -> torch.Tensor:
    """Normalised crops (N, 3, crop, crop_w) -> (N, 133, crop / 4, crop_w / 4)."""
    if flip:
        perm = list(range(d.keypoints))
        for a, b in flip_pairs():
            perm[a], perm[b] = b, a
        n = crops.shape[0]
        both = heatmaps(w, torch.cat([crops, crops.flip(-1)]), d, False)
        return (both[:n] + both[n:][:, perm].flip(-1)) * 0.5
    x = hamer.vit(w, crops, d.vit)
    n, _, c = x.shape
    x = x.transpose(1, 2).reshape(n, c, d.vit.crop // d.vit.patch,
                                  d.vit.crop_w // d.vit.patch)
    h = "keypoint_head.deconv_layers."
    for i in (0, 3):
        x = F.conv_transpose2d(x, w[f"{h}{i}.weight"], stride=2, padding=1)
        bn = f"{h}{i + 1}."
        x = ((x - w[bn + "running_mean"][:, None, None])
             / torch.sqrt(w[bn + "running_var"][:, None, None] + 1e-5)
             * w[bn + "weight"][:, None, None] + w[bn + "bias"][:, None, None])
        x = F.relu(x)
    return F.conv2d(x, w["keypoint_head.final_layer.weight"],
                    w["keypoint_head.final_layer.bias"])


def _blur(heat: np.ndarray, kernel: int) -> np.ndarray:
    """cv2's ``GaussianBlur(heat, (kernel, kernel), 0)`` per map, reflected
    edges (BORDER_REFLECT_101)."""
    sigma = 0.3 * ((kernel - 1) * 0.5 - 1) + 0.8
    r = kernel // 2
    g = np.exp(-np.arange(-r, r + 1) ** 2 / (2 * sigma * sigma))
    g /= g.sum()
    x = np.pad(heat, ((0, 0), (r, r), (r, r)), mode="reflect")
    x = sum(g[i] * x[:, i:i + heat.shape[1], :] for i in range(kernel))
    return sum(g[i] * x[:, :, i:i + heat.shape[2]] for i in range(kernel))


def decode(heat: np.ndarray, center, scale, kernel: int = 11,
           argmax: Optional[np.ndarray] = None, gap: float = 0.0,
           keypoints: Optional[np.ndarray] = None) -> Dict:
    """One person's heatmaps (K, H, W) -> ``keypoints`` (K, 2) in frame
    pixels, ``confidence`` (K,) and the ``argmax`` used (K,).

    With the program's choices: where ``argmax`` reads within ``gap`` of
    the maximum, it is taken in place of the reference's own; where that
    argmax is used and the Newton step's sensitivity (the norm of (H +
    eps I)^-1 times 1 + the step's length: heatmap pixels per unit of log
    heat) times ``gap`` exceeds one heatmap pixel, heat values within the
    gap do not fix the refinement, and the program's ``keypoints`` (K, 2)
    are taken."""
    k, h, w = heat.shape
    flat = heat.reshape(k, -1).astype(np.float64)
    idx = flat.argmax(1)
    if argmax is not None:
        theirs = flat[np.arange(k), argmax]
        idx = np.where(theirs >= flat.max(1) - gap, argmax, idx)
    conf = flat[np.arange(k), idx]
    preds = np.stack([idx % w, idx // w], -1).astype(np.float64)
    preds[conf <= 0] = -1
    logs = np.log(np.clip(_blur(heat.astype(np.float64), kernel), 0.001, 50))
    pad = np.pad(logs, ((0, 0), (1, 1), (1, 1)), mode="edge")
    px = np.clip(preds[:, 0].astype(int) + 1, 1, w)
    py = np.clip(preds[:, 1].astype(int) + 1, 1, h)
    at = lambda dy, dx: pad[np.arange(k), py + dy, px + dx]
    i_, ix1, iy1, ix1y1 = at(0, 0), at(0, 1), at(1, 0), at(1, 1)
    ix1_y1_, ix1_, iy1_ = at(-1, -1), at(0, -1), at(-1, 0)
    grad = np.stack([0.5 * (ix1 - ix1_), 0.5 * (iy1 - iy1_)], -1)[..., None]
    dxx = ix1 - 2 * i_ + ix1_
    dyy = iy1 - 2 * i_ + iy1_
    dxy = 0.5 * (ix1y1 - ix1 - iy1 + i_ + i_ - ix1_ - iy1_ + ix1_y1_)
    hess = np.stack([dxx, dxy, dxy, dyy], -1).reshape(k, 2, 2)
    hess = np.linalg.inv(hess + np.finfo(np.float32).eps * np.eye(2))
    step = (hess @ grad)[..., 0]
    coords = preds - step
    size = np.asarray(scale) * 200.0
    kp = np.stack([coords[:, 0] * size[0] / (w - 1.0) + center[0] - size[0] * 0.5,
                   coords[:, 1] * size[1] / (h - 1.0) + center[1] - size[1] * 0.5], -1)
    if keypoints is not None:
        sens = np.linalg.norm(hess, 2, axis=(1, 2)) * (1.0 + np.linalg.norm(step, axis=-1))
        taken = (idx == argmax) & (sens * gap > 1.0)
        kp = np.where(taken[:, None], np.asarray(keypoints, np.float64), kp)
    return {"keypoints": kp, "confidence": conf, "argmax": idx}


def hand_boxes(kp_px: np.ndarray, valid: np.ndarray, d: hamer.Dims = hamer.DIMS
               ) -> np.ndarray:
    """Both hands' keypoints (2, 21, 2) in input pixels and their validity
    (2, 21) -> boxes (2, 3): centre x, y and side, from the valid
    keypoints (all 21 where a hand has none)."""
    out = np.zeros((2, 3))
    for hand in range(2):
        use = valid[hand] if valid[hand].any() else np.ones(21, bool)
        p = np.asarray(kp_px[hand], np.float64)[use]
        lo, hi = p.min(0), p.max(0)
        wd, ht = 2.0 * (hi - lo)
        out[hand] = [*((lo + hi) / 2), max(hamer.expand_to_aspect_ratio(
            wd, ht, (d.crop_w, d.crop)))]
    return out


def hand_crop(image: torch.Tensor, box, left: bool, d: hamer.Dims = hamer.DIMS,
              device="cpu") -> torch.Tensor:
    """``hamer.crop`` of ``image`` (H, W, 3) in 0..255 with the blur's
    radius held to ``BLUR_RADIUS``: RGB (3, crop, crop_w), float32."""
    cx, cy, side = (float(v) for v in box)
    img = torch.as_tensor(image, dtype=torch.float64, device=device)
    factor = float(np.float32(side) / np.float32(d.crop) / np.float32(2.0))
    if factor > np.float32(1.1):
        sigma = float(np.float32(factor - 1.0) / np.float32(2.0))
        r = min(int(4.0 * sigma + 0.5), BLUR_RADIUS)
        taps = np.exp(-0.5 / sigma ** 2 * np.arange(-r, r + 1) ** 2)
        taps = taps / taps.sum()
        for axis in (0, 1):
            n = img.shape[axis]
            idx = lambda o: torch.as_tensor(np.clip(np.arange(n) + o, 0, n - 1),
                                            device=img.device)
            img = sum(float(taps[o + r]) * img.index_select(axis, idx(o))
                      for o in range(-r, r + 1))
    if left:
        img = img.flip(1)
        cx = img.shape[1] - cx - 1
    k = side / d.crop
    grid = torch.arange(d.crop, dtype=torch.float64, device=device) - d.crop / 2
    sy, sx = cy + grid * k, cx + grid * k
    y0, x0 = torch.floor(sy), torch.floor(sx)
    fy, fx = (sy - y0)[:, None, None], (sx - x0)[None, :, None]
    y0, x0 = y0.long(), x0.long()

    def px(yy, xx):
        ok = ((yy >= 0) & (yy < img.shape[0]))[:, None] & \
            ((xx >= 0) & (xx < img.shape[1]))[None, :]
        v = img[yy.clamp(0, img.shape[0] - 1)][:, xx.clamp(0, img.shape[1] - 1)]
        return v * ok[..., None]
    patch = ((1 - fy) * (1 - fx) * px(y0, x0) + (1 - fy) * fx * px(y0, x0 + 1)
             + fy * (1 - fx) * px(y0 + 1, x0) + fy * fx * px(y0 + 1, x0 + 1))
    patch = (patch - torch.as_tensor(hamer.MEAN, device=device)) / \
        torch.as_tensor(hamer.STD, device=device)
    cut = (d.crop - d.crop_w) // 2
    return patch.permute(2, 0, 1)[:, :, cut:cut + d.crop_w].float()


def hands(keypoints: np.ndarray, conf: np.ndarray, found: bool):
    """(133, 2), (133,) -> the hands' keypoints (2, 21, 2), validity (2,
    21) and detection (2,), left first."""
    kp = np.stack([keypoints[LEFT:LEFT + 21], keypoints[RIGHT:RIGHT + 21]])
    c = np.stack([conf[LEFT:LEFT + 21], conf[RIGHT:RIGHT + 21]])
    valid = (c > KP_CONF) & found
    return kp, valid, valid.sum(-1) > MIN_VALID
