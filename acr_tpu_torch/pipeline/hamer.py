"""HaMeR on the detector's hands: the crop stage, the network and the
camera, on the device at a fixed shape of two crops a frame.

The box of each hand is HaMeR's demo's, from the detector's joints in the
pixels of the step's input: ACR's 21 projected joints (``pj2d``) of the
letterboxed network input, or ViTPose's valid hand keypoints in the 1024
px resized frame (``pipeline/vitdet.py``): the joints' min/max box, its
centre, its size times 2.0 (the demo's ``rescale_factor``) widened to
the aspect 192:256, and the larger side (``boxes_from_joints``: (cx, cy,
side) per hand).

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
zero. Unlike the demo, the crop comes from the input the step already
holds (ACR's 512 px letterbox, or ViTDet's 1024 px resized frame), not
from the camera frame, and is sampled in float32 at exact positions (cv2
rounds positions to 1/32 px).

The network (``models.hamer.HaMeR``) regresses right-hand MANO in the
crop; the rotations are turned into axis-angle, the parser's output
form, so that OneEuro (``pipeline.temporal``) filters them as it does
ACR's. The crop's weak-perspective camera is carried to the frame's
translation (``cam_crop_to_full``) at HaMeR's focal length scaled to
the input (5000 / 256 x 512 = 10000 px), with the left camera's x offset
negated (the demo's multiplier). The tail (``Regressor.tail``): both
hands through the right MANO without the mean pose and without root
alignment, the left mesh mirrored in x, and the joints projected through
the translation, then into the original frame
(``project.kp2d_to_org_image``).

``Regressor`` holds the network on the device and the tail, which the
app installs as its pipeline's mesh tail (``ACRPipeline.tail``), so that
every mesh of a step, the regressed poses' and with ``-t`` OneEuro's,
comes out of ``ACRPipeline.refine``; ``CROPS`` counts the crops issued,
on the host, with no sync.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from acr_tpu_torch.models import hamer as hamer_model
from acr_tpu_torch.ops.rotations import rotmat_to_axis_angle
from acr_tpu_torch.pipeline.infer import apply_mano
from acr_tpu_torch.pipeline.project import kp2d_to_org_image

log = logging.getLogger("acr_tpu_torch")

CROPS: Dict[str, int] = {"crops": 0}

FOCAL = 5000.0          # HaMeR's focal length at the crop's size (EXTRA.FOCAL_LENGTH)
RESCALE = 2.0           # the demo's rescale_factor
BLUR_AT = 1.1           # the demo blurs above this downsampling factor
BLUR_RADIUS = 32        # the widest kernel the device blur holds (sigma <= 7.875)
MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)


def boxes_from_joints(px: torch.Tensor, dims: hamer_model.Dims,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Joints px (B, 2, 21, 2) in input pixels -> boxes (B, 2, 3): centre
    x, y and side in input pixels. Widening (w, h) to the aspect
    crop_w:crop and taking the larger side is ``max(h, w * crop /
    crop_w)``. With ``valid`` (B, 2, 21) the box spans the valid joints
    alone (the demo's rule on ViTPose's keypoints), and all 21 of a hand
    with none."""
    if valid is None:
        lo, hi = px.amin(-2), px.amax(-2)
    else:
        valid = (valid | ~valid.any(-1, keepdim=True))[..., None]
        lo = torch.where(valid, px, torch.full_like(px, float("inf"))).amin(-2)
        hi = torch.where(valid, px, torch.full_like(px, float("-inf"))).amax(-2)
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
    """images (N, 3, H, W) float, each through its own separable kernel
    (N, K), rows then columns, nearest edges."""
    n, c, h, w_ = images.shape
    r = kernels.shape[1] // 2
    w = kernels.repeat_interleave(c, 0)
    x = F.pad(images.reshape(1, n * c, h, w_), (r, r, r, r), mode="replicate")
    x = F.conv2d(x, w[:, None, :, None], groups=n * c)
    x = F.conv2d(x, w[:, None, None, :], groups=n * c)
    return x.reshape(n, c, h, w_)


def lerp(images: torch.Tensor, pos: torch.Tensor, dim: int) -> torch.Tensor:
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
    """image (B, H, W, 3) RGB, uint8 or float in 0..255, boxes (B, 2, 3),
    detected (B, 2) -> normalised crops (B * 2, 3, crop, crop_w), left
    hand first."""
    b, h, w = image.shape[:3]
    n = 2 * b
    dev = image.device
    img = image.permute(0, 3, 1, 2).float()[:, None].expand(b, 2, 3, h, w)
    box = boxes.reshape(n, 3)
    img = blur(img.reshape(n, 3, h, w), blur_kernels(box[:, 2], dims))
    k = box[:, 2:3] / dims.crop
    half = dims.crop / 2.0
    cut = (dims.crop - dims.crop_w) // 2
    rows = torch.arange(dims.crop, device=dev, dtype=torch.float32) - half
    cols = torch.arange(cut, cut + dims.crop_w, device=dev,
                        dtype=torch.float32) - half
    # the left hand (even rows) samples the image mirrored about its centre
    sign = (torch.arange(n, device=dev) % 2).to(torch.float32)[:, None] * 2.0 - 1.0
    img = lerp(img, box[:, 1:2] + rows[None] * k, 2)
    img = lerp(img, box[:, 0:1] + sign * cols[None] * k, 3)
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


def mirrored_faces(right: np.ndarray) -> np.ndarray:
    """(2, F, 3) faces of two right MANO meshes whose first is mirrored:
    its faces re-wound, so that they face out as the right's do."""
    return np.stack([np.ascontiguousarray(right[:, ::-1]), right])


class Regressor:
    """HaMeR's network on ``device`` (fp32, TF32 off as the pipeline sets
    it) holding ``params`` (HaMeR's checkpoint names), or seeded stand-in
    weights with a warning where none are given, and its tail through
    ``mano``, the right MANO asset of the detector's pipeline."""

    # the regress stage's output that the tail takes as its camera
    CAMERA = "cam_trans"

    def __init__(self, cfg, params: Optional[Dict[str, torch.Tensor]],
                 mano, device: torch.device):
        self.cfg, self.mano = cfg, mano
        self.dims = hamer_model.DIMS
        self.focal = FOCAL / self.dims.crop * cfg.input_size
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

    @torch.no_grad()
    def regress(self, image: torch.Tensor, joints: torch.Tensor,
                valid: Optional[torch.Tensor], detected: torch.Tensor,
                stage=contextlib.nullcontext) -> Dict[str, torch.Tensor]:
        """The crops of ``image`` (B, H, W, 3) around each hand's
        ``joints`` (B, 2, 21, 2, input pixels; with ``valid`` only those
        valid), the network and the camera: ``hamer_params`` (B, 2, 109,
        the regressed 6D pose, betas and crop camera), ``boxes``,
        ``poses`` (B, 2, 48 axis-angle), ``betas``, ``cam`` (the left x
        offset negated) and ``cam_trans``, the frame's translation."""
        b = image.shape[0]
        with stage("regress.crop"):
            boxes = boxes_from_joints(joints, self.dims, valid)
            x = crops(image, boxes, detected, self.dims)
        with stage("regress.net"):
            p = self.net(x).reshape(b, 2, hamer_model.N_PARAMS)
            rot = hamer_model.rot6d_to_rotmat(
                p[..., :hamer_model.N_POSE].reshape(b, 2, 16, 6))
            cam = _mirror_left(p[..., -hamer_model.N_CAM:], axis=1)
            return {"hamer_params": p, "boxes": boxes,
                    "poses": rotmat_to_axis_angle(rot).reshape(b, 2, 48),
                    "betas": p[..., hamer_model.N_POSE:-hamer_model.N_CAM],
                    "cam": cam,
                    "cam_trans": cam_crop_to_full(cam, boxes, self.cfg.input_size,
                                                  self.focal)}

    def tail(self, poses: torch.Tensor, betas: torch.Tensor,
             trans: torch.Tensor, offsets: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        """MANO and the camera: ``poses`` (B, 2, 48) axis-angle, ``betas``
        (B, 2, 10), ``trans`` (B, 2, 3) the frame's translation and
        ``offsets`` (B, 10). Both hands go through the right MANO without
        the mean pose or root alignment."""
        b = poses.shape[0]
        verts, j3d, _ = apply_mano(self.mano, poses.reshape(2 * b, -1),
                                   betas.reshape(2 * b, -1), None,
                                   add_mean=False)
        verts = _mirror_left(verts.reshape(b, 2, -1, 3))
        j3d = _mirror_left(j3d.reshape(b, 2, -1, 3))
        half = self.cfg.input_size / 2.0

        def project(p):
            q = p + trans[:, :, None]
            return self.focal * q[..., :2] / q[..., 2:3] / half

        pj2d = project(j3d)
        return {"verts": verts, "j3d": j3d,
                "verts_camed": torch.cat([project(verts), verts[..., 2:]], -1),
                "pj2d": pj2d,
                "pj2d_org": kp2d_to_org_image(pj2d, offsets[:, None, :]),
                "cam_trans": trans}
