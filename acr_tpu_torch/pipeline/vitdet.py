"""HaMeR's published detector chain on the device: ViTDet-H finds the
person, ViTPose-H its 133 whole-body keypoints, and the hand keypoints
give HaMeR its boxes (``detector='vitdet'``, the demo of
github.com/geopavlakos/hamer).

The stage (``ViTDetPipeline``, the app's pipeline in ACR's place), per
frame, at fixed shapes, with no host wait:

1. the RGB frame (``preprocess.vitdet_preprocess``) resized on the device,
   bilinear in float32, so that its longer side is ``input_size``
   (``resize_input``, detectron2's ``ResizeShortestEdge(1024, 1024)``),
   normalised by detectron2's mean and std, zero-padded at the bottom and
   right to the ``input_size`` square;
2. ViTDet-H (``models.vitdet``): the detections, in decreasing score;
3. the person: the best detection of class 0 above 0.5, at most one a
   frame (the demo takes every such person), its box scaled back to the
   frame (detectron2's ``detector_postprocess``);
4. ViTPose-H (``models.vitpose``) on the person's 256 x 192 UDP crop,
   sampled from the resized frame in float32 at exact positions, with
   its flip test, decoded into the frame's pixels;
5. the hands: keypoints 91-111 (left) and 112-132 (right); a keypoint is
   valid above a confidence of 0.5, a hand is detected with more than 3
   valid keypoints, its box spans them (``pipeline.hamer
   .boxes_from_joints``, with the validity mask).

Its outputs: ``person_box`` (B, 4, frame pixels), ``person_score``,
``person_roi`` (the person's first-stage proposal, input pixels),
``persons`` (B,) the detections of class 0 above 0.5, ``keypoints`` (B,
133, 2, frame pixels), ``kp_conf``, ``kp_argmax`` (each heatmap's flat
argmax), ``hand_kp`` (B, 2, 21, 2, input pixels), ``hand_valid`` and
``detection_flag`` (B, 2), and ``_detect`` (B, 4): persons, over the cap
of one, hands detected, hands missing, which the app adds to ``DETECT``
when it reads the frame back (``count``). At batch 1 on a card the
stage replays its CUDA graph (``StepGraph("detect")``); eagerly it marks
``detect.backbone``, ``detect.rpn``, ``detect.roi`` and ``detect.pose``.

The pipeline holds both MANO assets and runs the architecture's mesh
tail (``tail``, HaMeR's, which the app installs) in ``refine``, as
``ACRPipeline`` does. The weights come under ``vitdet.`` (detectron2's
names) and ``vitpose.`` (mmpose's); without them it serves seeded
stand-ins with a warning.
"""

from __future__ import annotations

import collections
import contextlib
import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from acr_tpu_torch.config import Config
from acr_tpu_torch.models import vitdet as vitdet_model
from acr_tpu_torch.models import vitpose as vitpose_model
from acr_tpu_torch.pipeline import graphs
from acr_tpu_torch.pipeline.hamer import lerp
from acr_tpu_torch.pipeline.infer import load_manos, set_fp32_math
from acr_tpu_torch.pipeline.preprocess import resized_shape, vitdet_preprocess
from acr_tpu_torch.utils.device import resolve_device

log = logging.getLogger("acr_tpu_torch")

# frames' detections read back: persons above 0.5, frames whose persons
# were over the cap of one, hands detected, hands missing
DETECT: Dict[str, int] = collections.Counter()

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
PERSON_SCORE = 0.5
KP_CONF = 0.5
MIN_KEYPOINTS = 3
HAND_KP = 21


def count(counts) -> None:
    """Add a read-back ``_detect`` (B, 4) to ``DETECT``."""
    for col, name in enumerate(("persons", "over_cap", "hands", "hands_missing")):
        DETECT[name] += int(counts[:, col].sum())


def resize_input(frames: torch.Tensor, size: int) -> torch.Tensor:
    """RGB frames (B, H, W, 3) uint8 -> float (B, 3, h, w) in 0..255, the
    longer side ``size`` (``preprocess.resized_shape``), bilinear."""
    hw = resized_shape(frames.shape[1], frames.shape[2], size)
    x = frames.permute(0, 3, 1, 2).float()
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False)


def normalise_pad(image: torch.Tensor, size: int) -> torch.Tensor:
    """(B, 3, h, w) in 0..255 -> detectron2's normalised input, zero-padded
    at the bottom and right to (B, 3, size, size)."""
    x = torch.stack([(image[:, c] - PIXEL_MEAN[c]) / PIXEL_STD[c]
                     for c in range(3)], 1)
    return F.pad(x, (0, size - image.shape[3], 0, size - image.shape[2]))


def hands(keypoints: torch.Tensor, conf: torch.Tensor, found: torch.Tensor):
    """Keypoints (B, 133, 2), confidences (B, 133), person found (B,) ->
    the hands' keypoints (B, 2, 21, 2), their validity (B, 2, 21) and
    each hand's detection (B, 2), left first."""
    kp = torch.stack([keypoints[:, s:s + HAND_KP] for s in
                      (vitpose_model.LEFT_HAND, vitpose_model.RIGHT_HAND)], 1)
    c = torch.stack([conf[:, s:s + HAND_KP] for s in
                     (vitpose_model.LEFT_HAND, vitpose_model.RIGHT_HAND)], 1)
    valid = (c > KP_CONF) & found[:, None, None]
    return kp, valid, valid.sum(-1) > MIN_KEYPOINTS


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN held to deterministic algorithms, so that a frame's keypoints
    repeat bit for bit: ViTPose's overlapping transposed convolutions
    otherwise sum with atomics, in another order each call (the pyramid's,
    2 x 2 at stride 2, repeat as they are, and are faster unrestricted). A
    graph captured inside keeps the algorithms chosen."""
    keep = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = keep


def _split(params: Optional[Dict[str, torch.Tensor]], prefix: str):
    if not params:
        return None
    out = {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}
    return out or None


class ViTDetPipeline:
    """ViTDet-H and ViTPose-H on ``device`` (fp32, TF32 off), the MANO
    assets and the mesh tail; called as ``ACRPipeline`` is."""

    def __init__(self, cfg: Config, params=None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        set_fp32_math()
        self.mesh = None
        self.replicas = []
        size = cfg.input_size
        dev = self.device
        det = _split(params, "vitdet.")
        pose = _split(params, "vitpose.")
        if det is None or pose is None:
            log.warning("ViTDet/ViTPose: no trained weights given (vitdet.* "
                        "and vitpose.* keys); serving seeded stand-in weights")
        if det is None:
            det = vitdet_model.init_params(torch.Generator(device=dev).manual_seed(1),
                                           vitdet_model.DIMS, size, dev)
        if pose is None:
            pose = vitpose_model.init_params(torch.Generator(device=dev).manual_seed(2),
                                             vitpose_model.DIMS, dev)
        # built on the meta device, then holding the given tensors in place
        with torch.device("meta"):
            self.detector = vitdet_model.ViTDet(vitdet_model.DIMS, size)
            self.pose = vitpose_model.ViTPose(vitpose_model.DIMS)
        for net, state in ((self.detector, det), (self.pose, pose)):
            net.load_state_dict({k: v.to(dev) if not v.is_floating_point()
                                 else v.to(dev, torch.float32)
                                 for k, v in state.items()},
                                strict=True, assign=True)
            net.eval().requires_grad_(False)
        self.pose.flip_perm = vitpose_model.flip_order(
            vitpose_model.DIMS.keypoints).to(dev)
        self.mano_l, self.mano_r, self.faces = load_manos(cfg, dev)
        self.tail: Optional[Callable[..., Dict[str, torch.Tensor]]] = None
        self.stage = contextlib.nullcontext           # the eager spans
        self._graph = graphs.StepGraph("detect", dev)

    # the app's span around the call and the frame's host preprocess
    # (``ACRPipeline`` for what the app asks of a pipeline)
    span = "issue.detect"
    preprocess = staticmethod(vitdet_preprocess)

    def hand_inputs(self, image: torch.Tensor, out: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """The frame and its hand keypoints with their validity."""
        return {"image": image, "hand_kp": out["hand_kp"],
                "hand_valid": out["hand_valid"]}

    def hands(self, d: Dict[str, torch.Tensor]):
        """``hand_inputs`` -> the resized frame that the crops sample, the
        hand keypoints in its pixels and their validity."""
        return self.input_image(d["image"]), d["hand_kp"], d["hand_valid"]

    def count(self, out: Dict) -> None:
        """Pop a read-back ``_detect`` into ``DETECT``."""
        counts = out.pop("_detect", None)
        if counts is not None:
            count(np.asarray(counts))

    def counts_text(self) -> str:
        from acr_tpu_torch.ops.detect import LAUNCHES
        return f"; detections {dict(DETECT)}; detect kernels {dict(LAUNCHES)}"

    def graph_block(self, batch: int) -> Optional[str]:
        """Why a step of ``batch`` frames runs eagerly (``cpu`` or
        ``batch``), or None where the stage replays its CUDA graph."""
        if self.device.type != "cuda":
            return "cpu"
        return "batch" if batch != 1 else None

    @torch.no_grad()
    def __call__(self, image, offsets, return_maps: bool = False, why=...
                 ) -> Dict[str, torch.Tensor]:
        """RGB frames uint8 (B, H, W, 3) and offsets (B, 10) -> the
        detections (device tensors), through the stage's graph at batch 1
        on a card."""
        image = torch.as_tensor(image)
        offsets = torch.as_tensor(offsets, dtype=torch.float32)
        if why is ...:
            why = self.graph_block(image.shape[0])
        return self._graph(why, None, lambda d: self.detect(d["image"]),
                           {"image": image, "offsets": offsets},
                           eager=lambda d: self.detect(d["image"], self.stage))

    def input_image(self, frames: torch.Tensor) -> torch.Tensor:
        """The resized frames (B, h, w, 3) float, which every crop samples."""
        return resize_input(frames, self.cfg.input_size).permute(0, 2, 3, 1)

    def detect(self, frames: torch.Tensor, stage=contextlib.nullcontext
               ) -> Dict[str, torch.Tensor]:
        outs = [self._frame(frames[i:i + 1], stage) for i in range(frames.shape[0])]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def _frame(self, frame: torch.Tensor, stage) -> Dict[str, torch.Tensor]:
        size = self.cfg.input_size
        h, w = frame.shape[1:3]
        img = resize_input(frame, size)                     # (1, 3, rh, rw)
        rh, rw = img.shape[2:]
        det = self.detector(normalise_pad(img, size), (rh, rw), stage)
        with stage("detect.pose"):
            person = det["valid"] & (det["classes"] == 0) & \
                (det["scores"] > PERSON_SCORE)
            persons = person.sum()
            best = person.int().argmax().view(1)
            found = person.any().view(1)
            # frame pixels per input pixel, as detector_postprocess scales
            sx, sy = w / rw, h / rh
            b = det["boxes"][best]
            box = torch.stack([(b[:, 0] * sx).clamp(0, w), (b[:, 1] * sy).clamp(0, h),
                               (b[:, 2] * sx).clamp(0, w), (b[:, 3] * sy).clamp(0, h)],
                              -1)
            # no person: a zero box, whose keypoints are never valid
            box = torch.where(found[:, None], box, torch.zeros_like(box))
            roi = torch.where(found[:, None], det["rois"][best],
                              torch.zeros_like(box))
            pd = vitpose_model.DIMS
            center, sc = vitpose_model.center_scale(box, pd)
            ys, xs = vitpose_model.warp_positions(center, sc, pd)
            crop = lerp(lerp(img, ys / sy, 2), xs / sx, 3)
            with deterministic_cudnn():
                heat = self.pose(vitpose_model.normalise(crop))
            dec = vitpose_model.decode(heat, center, sc, pd.dark_kernel)
            kp, valid, detected = hands(dec["keypoints"], dec["confidence"], found)
            kp = torch.stack([kp[..., 0] / sx, kp[..., 1] / sy], -1)
            n_hands = detected.sum(-1, dtype=torch.int32)
            return {
                "person_box": box, "person_roi": roi,
                "person_score": torch.where(found, det["scores"][best],
                                            torch.zeros_like(found, dtype=torch.float32)),
                "persons": persons.view(1).to(torch.int32),
                "keypoints": dec["keypoints"], "kp_conf": dec["confidence"],
                "kp_argmax": dec["argmax"], "hand_kp": kp, "hand_valid": valid,
                "detection_flag": detected,
                "_detect": torch.stack([persons.to(torch.int32),
                                        (persons > 1).to(torch.int32),
                                        n_hands[0], 2 - n_hands[0]])[None]}

    @torch.no_grad()
    def refine(self, poses, betas, cam, offsets) -> Dict[str, torch.Tensor]:
        """The architecture's mesh tail on the pipeline's device."""
        dev = self.device
        poses, betas, cam = (torch.as_tensor(t).to(dev) for t in (poses, betas, cam))
        offsets = torch.as_tensor(offsets, dtype=torch.float32).to(dev)
        return self.tail(poses, betas, cam, offsets)
