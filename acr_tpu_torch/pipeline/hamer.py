"""HaMeR on the detector's hands: the crop stage, the network and the
camera, on the device at a fixed shape of two crops a frame.

The box of each hand is HaMeR's demo's, from the 21 projected joints of
ACR's detection (``pj2d``) in the pixels of the letterboxed network
input: the joints' min/max box, its centre, its size times 2.0 (the
demo's ``rescale_factor``) widened to the aspect 192:256, and the larger
side (``boxes_from_joints``: (cx, cy, side) per hand).

The crop (``crops``) is the demo's ``ViTDetDataset``: where the box is
more than 1.1 x twice the crop's side, the image is first blurred with a
Gaussian of sigma (side / 512 - 1) / 2 against aliasing (scipy's kernel,
radius ``int(4 sigma + 0.5)``, nearest edges; the device holds radii up
to ``BLUR_RADIUS``); then an affine bilinear warp of the box onto a
256 x 256 crop, pixel centres at integer positions as in cv2's
``warpAffine``, zero outside the image, mirrored for the left hand
(its box centre mirrored, as the demo flips the image); then the
ImageNet normalisation and the middle 192 columns. The network input is
RGB already, so no channel swap is needed. Crops of undetected hands are
zero. Unlike the demo, the crop comes from the 512 px input the step
already holds, not from the camera frame, and is sampled in float32 at
exact positions (cv2 rounds positions to 1/32 px).

The network (``models.hamer.HaMeR``) regresses right-hand MANO in the
crop; the rotations are turned into axis-angle, the parser's output
form, so that OneEuro (``pipeline.temporal``) filters them as it does
ACR's. The tail (``tail``): both hands through the right MANO without
the mean pose and without root alignment, the left mesh mirrored in x
and its camera's x offset negated (the demo's multiplier), the crop's
weak-perspective camera carried to the frame's (``cam_crop_to_full``)
at HaMeR's focal length scaled to the input (5000 / 256 x 512 = 10000
px), and the joints projected through it, then into the original frame
(``project.kp2d_to_org_image``).

``Regressor`` holds the network on the device and the stage's CUDA
graph (``StepGraph("regress")``); ``CROPS`` counts the crops issued, on
the host, with no sync.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from acr_tpu_torch.models import hamer as hamer_model
from acr_tpu_torch.ops.rotations import rotmat_to_axis_angle
from acr_tpu_torch.pipeline import graphs
from acr_tpu_torch.pipeline.project import kp2d_to_org_image

log = logging.getLogger("acr_tpu_torch")

CROPS: Dict[str, int] = {"crops": 0}

FOCAL = 5000.0          # HaMeR's focal length at the crop's size (EXTRA.FOCAL_LENGTH)
RESCALE = 2.0           # the demo's rescale_factor
BLUR_AT = 1.1           # the demo blurs above this downsampling factor
BLUR_RADIUS = 32        # the widest kernel the device blur holds (sigma <= 7.875)
MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)


def boxes_from_joints(pj2d: torch.Tensor, input_size: int,
                      dims: hamer_model.Dims) -> torch.Tensor:
    """pj2d (B, 2, 21, 2) in [-1, 1] -> boxes (B, 2, 3): centre x, y and
    side in input pixels. Widening (w, h) to the aspect crop_w:crop and
    taking the larger side is ``max(h, w * crop / crop_w)``."""
    px = (pj2d + 1.0) * (input_size / 2.0)
    lo, hi = px.amin(-2), px.amax(-2)
    wh = RESCALE * (hi - lo)
    side = torch.maximum(wh[..., 1], wh[..., 0] * (dims.crop / dims.crop_w))
    return torch.cat([(lo + hi) / 2.0, side[..., None]], -1)


def blur_kernels(side: torch.Tensor, dims: hamer_model.Dims) -> torch.Tensor:
    """side (N,) -> (N, 2 * BLUR_RADIUS + 1) normalised 1D Gaussians, a
    unit impulse where the box needs no blur."""
    factor = side / dims.crop / 2.0
    on = factor > BLUR_AT
    sigma = torch.where(on, (factor - 1.0) / 2.0, torch.ones_like(factor))
    radius = torch.floor(4.0 * sigma + 0.5)
    taps = torch.arange(-BLUR_RADIUS, BLUR_RADIUS + 1, device=side.device,
                        dtype=side.dtype)
    w = torch.exp(-0.5 / (sigma * sigma)[:, None] * (taps * taps)[None])
    w = torch.where(taps.abs()[None] <= radius[:, None], w, torch.zeros_like(w))
    w = torch.where(on[:, None], w, (taps == 0).to(w.dtype)[None])
    return w / w.sum(-1, keepdim=True)


def blur(images: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """images (N, 3, S, S) float, each through its own separable kernel
    (N, K), rows then columns, nearest edges."""
    n, c, s, _ = images.shape
    r = kernels.shape[1] // 2
    w = kernels.repeat_interleave(c, 0)
    x = F.pad(images.reshape(1, n * c, s, s), (r, r, r, r), mode="replicate")
    x = F.conv2d(x, w[:, None, :, None], groups=n * c)
    x = F.conv2d(x, w[:, None, None, :], groups=n * c)
    return x.reshape(n, c, s, s)


def _lerp(images: torch.Tensor, pos: torch.Tensor, dim: int) -> torch.Tensor:
    """Linear interpolation of ``images`` (N, C, H, W) along ``dim`` (2 or
    3) at positions ``pos`` (N, P), zero outside."""
    size = images.shape[dim]
    view = [pos.shape[0], 1, 1, 1]
    view[dim] = pos.shape[1]
    shape = list(images.shape)
    shape[dim] = pos.shape[1]
    p0 = torch.floor(pos)
    frac = (pos - p0).view(view)
    i0 = p0.long()

    def take(i):
        valid = ((i >= 0) & (i < size)).to(images.dtype).view(view)
        idx = i.clamp(0, size - 1).view(view).expand(shape)
        return torch.gather(images, dim, idx) * valid
    return take(i0) * (1.0 - frac) + take(i0 + 1) * frac


def crops(image: torch.Tensor, boxes: torch.Tensor, detected: torch.Tensor,
          dims: hamer_model.Dims) -> torch.Tensor:
    """image uint8 (B, S, S, 3) RGB, boxes (B, 2, 3), detected (B, 2) ->
    normalised crops (B * 2, 3, crop, crop_w), left hand first."""
    b, s = image.shape[0], image.shape[1]
    n = 2 * b
    dev = image.device
    img = image.permute(0, 3, 1, 2).float()[:, None].expand(b, 2, 3, s, s)
    box = boxes.reshape(n, 3)
    img = blur(img.reshape(n, 3, s, s), blur_kernels(box[:, 2], dims))
    k = box[:, 2:3] / dims.crop
    half = dims.crop / 2.0
    cut = (dims.crop - dims.crop_w) // 2
    rows = torch.arange(dims.crop, device=dev, dtype=torch.float32) - half
    cols = torch.arange(cut, cut + dims.crop_w, device=dev,
                        dtype=torch.float32) - half
    # the left hand (even rows) samples the image mirrored about its centre
    sign = (torch.arange(n, device=dev) % 2).to(torch.float32)[:, None] * 2.0 - 1.0
    img = _lerp(img, box[:, 1:2] + rows[None] * k, 2)
    img = _lerp(img, box[:, 0:1] + sign * cols[None] * k, 3)
    img = torch.stack([(img[:, c] - MEAN[c]) / STD[c] for c in range(3)], 1)
    return torch.where(detected.reshape(n, 1, 1, 1), img, torch.zeros_like(img))


def cam_crop_to_full(cam: torch.Tensor, boxes: torch.Tensor, input_size: int,
                     focal: float) -> torch.Tensor:
    """The crop's weak-perspective camera (s, tx, ty) -> the frame's
    translation (tx, ty, tz), HaMeR's ``cam_crop_to_full``."""
    bs = boxes[..., 2] * cam[..., 0] + 1e-9
    half = input_size / 2.0
    return torch.stack([2.0 * (boxes[..., 0] - half) / bs + cam[..., 1],
                        2.0 * (boxes[..., 1] - half) / bs + cam[..., 2],
                        2.0 * focal / bs], -1)


def _mirror_left(t: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Negate component ``axis`` of the left hand (hand axis 1)."""
    left = t[:, :1]
    left = torch.cat([left[..., :axis], -left[..., axis:axis + 1],
                      left[..., axis + 1:]], -1)
    return torch.cat([left, t[:, 1:]], 1)


def tail(mano_fn: Callable, poses: torch.Tensor, betas: torch.Tensor,
         cam: torch.Tensor, boxes: torch.Tensor, offsets: torch.Tensor,
         input_size: int) -> Dict[str, torch.Tensor]:
    """MANO and the camera: poses (B, 2, 48) axis-angle, betas (B, 2, 10),
    cam (B, 2, 3) with the left x offset negated, boxes (B, 2, 3), offsets
    (B, 10). ``mano_fn(poses, betas)`` is the right MANO without the mean
    pose or root alignment -> (verts, joints)."""
    b = poses.shape[0]
    verts, j3d = mano_fn(poses.reshape(2 * b, -1), betas.reshape(2 * b, -1))
    verts = _mirror_left(verts.reshape(b, 2, -1, 3))
    j3d = _mirror_left(j3d.reshape(b, 2, -1, 3))
    focal = FOCAL / hamer_model.DIMS.crop * input_size
    trans = cam_crop_to_full(cam, boxes, input_size, focal)
    half = input_size / 2.0

    def project(p):
        q = p + trans[:, :, None]
        return focal * q[..., :2] / q[..., 2:3] / half

    pj2d = project(j3d)
    return {"verts": verts, "j3d": j3d,
            "verts_camed": torch.cat([project(verts), verts[..., 2:]], -1),
            "pj2d": pj2d, "pj2d_org": kp2d_to_org_image(pj2d, offsets[:, None, :]),
            "cam_trans": trans}


def mirrored_faces(right: np.ndarray) -> np.ndarray:
    """(2, F, 3) faces of two right MANO meshes whose first is mirrored:
    its faces re-wound, so that they face out as the right's do."""
    return np.stack([np.ascontiguousarray(right[:, ::-1]), right])


def _no_stage(name: str):
    return contextlib.nullcontext()


class Regressor:
    """HaMeR's network on ``device`` (fp32, TF32 off as the pipeline sets
    it) holding ``params`` (HaMeR's checkpoint names), or seeded stand-in
    weights with a warning where none are given."""

    def __init__(self, cfg, params: Optional[Dict[str, torch.Tensor]],
                 device: torch.device):
        self.cfg, self.device = cfg, device
        self.dims = hamer_model.DIMS
        if not params:
            log.warning("HaMeR: no trained weights given (hamer.* keys); "
                        "serving seeded stand-in weights")
            params = hamer_model.init_params(
                torch.Generator(device=device).manual_seed(0), self.dims, device)
        # built on the meta device, then holding the given tensors (on
        # ``device``) in place: no second copy of the 2.7 GB of weights
        with torch.device("meta"):
            self.net = hamer_model.HaMeR(self.dims)
        self.net.load_state_dict({k: v.to(device, torch.float32)
                                  for k, v in params.items()},
                                 strict=True, assign=True)
        self.net.eval().requires_grad_(False)
        self.graph = graphs.StepGraph("regress", device)

    @torch.no_grad()
    def regress(self, refine: Callable, image: torch.Tensor,
                pj2d: torch.Tensor, detected: torch.Tensor,
                offsets: torch.Tensor, stage=_no_stage) -> Dict[str, torch.Tensor]:
        """The crops, the network and ``refine`` (the pipeline's MANO and
        camera tail, given the boxes): ``hamer_params`` (B, 2, 109, the
        regressed 6D pose, betas and crop camera), ``boxes``, ``poses``
        (B, 2, 48 axis-angle), ``betas``, ``cam`` (the left x offset
        negated) and the tail's outputs."""
        b = image.shape[0]
        with stage("regress.crop"):
            boxes = boxes_from_joints(pj2d, self.cfg.input_size, self.dims)
            x = crops(image, boxes, detected, self.dims)
        with stage("regress.net"):
            p = self.net(x).reshape(b, 2, hamer_model.N_PARAMS)
            rot = hamer_model.rot6d_to_rotmat(
                p[..., :hamer_model.N_POSE].reshape(b, 2, 16, 6))
            res = {"hamer_params": p, "boxes": boxes,
                   "poses": rotmat_to_axis_angle(rot).reshape(b, 2, 48),
                   "betas": p[..., hamer_model.N_POSE:-hamer_model.N_CAM],
                   "cam": _mirror_left(p[..., -hamer_model.N_CAM:], axis=1)}
            res.update(refine(res["poses"], res["betas"], res["cam"], offsets,
                              boxes=boxes))
        return res

    def issue(self, refine: Callable, image, out: Dict[str, torch.Tensor],
              offsets: torch.Tensor, why: Optional[str],
              stage=_no_stage) -> Dict[str, torch.Tensor]:
        """The regress stage of a step for the detections in ``out``:
        through the stage's CUDA graph where ``why`` is None, else eagerly,
        counted by its reason, with the nested stages ``regress.crop`` and
        ``regress.net``."""
        image = torch.as_tensor(image)
        CROPS["crops"] += 2 * image.shape[0]
        inputs = {"image": image, "pj2d": out["pj2d"],
                  "detection_flag": out["detection_flag"], "offsets": offsets}
        if why is None:
            return self.graph(None, lambda d: self.regress(
                refine, d["image"], d["pj2d"], d["detection_flag"],
                d["offsets"]), inputs)
        graphs.count_eager("regress", why)
        d = {k: v.to(self.device) for k, v in inputs.items()}
        return self.regress(refine, d["image"], d["pj2d"], d["detection_flag"],
                            d["offsets"], stage)
