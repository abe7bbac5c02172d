"""HaMeR's published chain, ViTDet-H -> ViTPose-H -> HaMeR (the demo of
github.com/geopavlakos/hamer, arXiv 2312.05251): what of a run is the
architecture's.

The configuration's ``"architecture": "hamer_vitdet"`` names this file;
its ``model`` runs the program with ``architecture='hamer'`` and
``detector='vitdet'``. The program resizes the camera frame to 1024 px,
finds the person with ViTDet-H (a plain ViT-H with windowed and global
relative-position attention, a simple feature pyramid, an RPN and three
cascade heads), crops the person for ViTPose-H whole-body, boxes each
hand from its valid keypoints and regresses it with HaMeR, as
``archs/hamer.py`` does on ACR's detections. References:
``reference/vitdet.py``, ``reference/vitpose.py`` and
``reference/hamer.py``.

Weights, seeded on the device: detectron2's and mmpose's layouts under
``vitdet.`` and ``vitpose.``, and HaMeR's under ``hamer.`` as
``archs/hamer.py`` makes them. Linear weights, position and
relative-position tables normal of std 0.02 cut at two standard
deviations (unit variance after the cut rescaled), convolutions of std
1 / sqrt(fan-in), biases 0, norms 1 and 0, BatchNorm at its identity.
The scene (``SCENE``), through the heads:

- the RPN's deltas keep their seeded draw, scaled by ``rpn_gain`` to the
  few tenths by which a trained RPN moves its anchors, and stretch every
  proposal's height by exp(``rpn_tall``), about 40x: the proposals are
  tall strips at the anchors' positions and widths, each at least 200
  px of the frame high, so that none is a sliver cut off at the padded
  square's lower edge (an anchor in the padding that reaches just past
  it, which no later stage could widen to the whole frame);
- every cascade stage's ``cls_score`` gives the person class
  ``person_logit`` over the rest, so that every RoI reads a person of
  about 0.8 and no other class passes 0.25;
- the first stage's ``bbox_pred`` keeps its seeded draw, so that the
  first two stages pool the proposals' own boxes; the second's and the
  third's widen their boxes by ``grow`` (before the clamp), so that
  every third-stage box is the whole frame (a box at the frame's edge
  gains about 32x a stage after the clip): NMS keeps exactly one person,
  whatever the frame;
- ViTPose's two deconvolutions upsample bilinearly (``BILINEAR``; their
  random kernels averaged over the taps, mixing the channels), so that
  the heatmaps are smooth and DARK's Newton step stays within a few
  heatmap pixels, as it does on a trained model's peaks (on random
  kernels it reaches thousands of pixels);
- ViTPose's ``final_layer`` lifts the first ``hand_valid`` keypoints of
  each hand to ``hand_conf[0]`` and the rest to ``hand_conf[1]``, its
  weights scaled by ``heat_gain``: both hands are detected, each with
  most of its first 11 keypoints valid and none of the rest.

Judge. The reference recomputes every frame the program processed, in
the program's order, detector first: its own proposals and detections.
Where its discrete choice is within a stated gap of the program's, it
takes the program's: the person (the program's first-stage proposal, if
the reference holds it and reads it within ``SCORE_GAP`` of its best),
each heatmap's argmax (within ``HEAT_GAP`` of the maximum), each
keypoint's DARK refinement where heat values within ``HEAT_GAP`` could
move it by more than a heatmap pixel (``reference/vitpose.py``
``decode``; on this scene's smooth heatmaps under 1 % of the hand
keypoints) and each hand keypoint's validity (confidence within
``CONF_GAP`` of 0.5). HaMeR then
runs on crops of the program's own boxes, as ``archs/hamer.py`` judges
them, with the blur's radius held to 32 px as the program holds it
(``reference/vitpose.py`` ``hand_crop``; only the scene's outlying
keypoints make boxes that reach it). Numbers, each the widest over the judged frames: ``persons_wrong``
(frames whose count of persons above 0.5 differs), ``kp_valid_wrong``
(hand keypoints whose validity differs beyond the gap), ``hands_wrong``
(frames whose detected hands differ), ``det_box_px`` and
``det_score_err`` (the person), ``kp_px`` (the hand keypoints the
reference holds valid, frame pixels) and ``kp_conf_err``, then HaMeR's
``box_px``, ``params_err``, ``verts_m``, ``cam_mesh_m`` and
``pj2d_px`` (over the joints at least ``NEAR_M`` in front of the
camera).

Work. ``detector_flops``: ``FlopCounterMode`` on the meta device over
the reference's networks at the published widths (the backbone, the
pyramid, the RPN's convolutions over p2-p6, the three box heads on 1000
RoIs, ViTPose on a crop and its mirror); ``flops_per_frame`` adds
HaMeR's. ``attention_work``, ``nms_work`` and ``roi_align_work``: a
frame's launches of the attention kernel, of NMS and of ROIAlignV2, and
the least time of each.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from port_bench.harness import manifest
from port_bench.harness.drivers import say
from port_bench.harness.judge import BLOCK, LEVELS, fp32_math
from port_bench.reference import camera, hamer, parse, render, temporal, vitdet, vitpose

HAMER = manifest.load_arch("hamer")

SCENE = {"rpn_gain": 0.2, "rpn_tall": 3.7, "person_logit": 6.0, "grow": 5.0,
         "head_gain": 0.25, "hand_valid": 11, "hand_conf": (0.5, -0.5),
         "heat_gain": 1.0}
# ViTPose's deconvolutions in the scene: bilinear 2x upsampling along the
# pixels, random across the channels
BILINEAR = (0.25, 0.75, 0.75, 0.25)

KEEP = ("verts", "j3d", "pj2d_org", "cam_trans", "boxes", "hamer_params",
        "detection_flag", "person_box", "person_score", "person_roi", "persons",
        "keypoints", "kp_conf", "kp_argmax", "hand_valid")

SCORE_GAP = 1e-4      # person scores of one RoI; rounding moves them ~1e-7
HEAT_GAP = 1e-4       # heatmap values near 0.5; rounding moves them ~1e-7
CONF_GAP = 1e-4       # a keypoint's confidence this close to 0.5
ROI_MATCH = 1e-2      # pixels: the program's proposal found among the reference's
# the RPN's choice of a proposal, which rounding can turn either way: an
# anchor's objectness, which rounding moves ~1e-5, and the IoU at which the
# NMS suppresses its box, ~3e-5 (boxes of 16 px and more, corners moved by
# up to 5e-4 px). The scene's many tall strips, a few columns apart,
# overlap each other at every IoU, some within that of the NMS's 0.7
RPN_GAP = 1e-4
IOU_GAP = 1e-3
# metres: pj2d_px reads the joints at least this far in front of the camera.
# The scene's outlying keypoints can box a hand in 3e5 px, which HaMeR's
# camera places 3 cm from the lens with joints behind it: they project to
# millions of pixels, where a rounding of 1e-7 m moves them by 15 px
# (cam_mesh_m still holds them in 3D)
NEAR_M = 0.1

_TRUNC = 0.87962566103423978


def _seeded(spec, seed: int, device, gain) -> Dict[str, torch.Tensor]:
    """Weights of ``spec`` (name, shape): the random ones from one draw."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    random = [(n, s) for n, s in spec if len(s) >= 2 or n.endswith("pos_embed")]
    flat = torch.randn(sum(math.prod(s) for _, s in random), generator=gen,
                       device=device)
    out, at = {}, 0
    for name, shape in random:
        n = math.prod(shape)
        std = 1.0 / math.sqrt(math.prod(shape[1:])) if len(shape) == 4 else 0.02
        out[name] = flat[at:at + n].view(shape).clamp_(-2.0, 2.0) * (
            std * gain(name) / _TRUNC)
        at += n
    del flat
    for name, shape in spec:
        if name not in out:
            t = torch.zeros(shape, device=device)
            if name.endswith(("weight", "running_var")):
                t.fill_(1.0)
            out[name] = t
    return out


def _detector_weights(seed: int, device, size: int) -> Dict[str, torch.Tensor]:
    d = vitdet.DIMS
    deltas = "proposal_generator.rpn_head.anchor_deltas."
    gain = lambda n: (SCENE["head_gain"] if n.startswith("roi_heads.box_predictor")
                      else SCENE["rpn_gain"] if n.startswith(deltas) else 1.0)
    w = _seeded(vitdet.param_shapes(d, size), 3 * int(seed) + 2, device, gain)
    w[deltas + "bias"].view(-1, 4)[:, 3] = SCENE["rpn_tall"]
    for k, weights in enumerate(d.cascade):
        p = f"roi_heads.box_predictor.{k}."
        w[p + "cls_score.bias"][0] = SCENE["person_logit"]
        if k:
            w[p + "bbox_pred.bias"][2] = SCENE["grow"] * weights[2]
            w[p + "bbox_pred.bias"][3] = SCENE["grow"] * weights[3]
    return {"vitdet." + k: v for k, v in w.items()}


def _pose_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    d = vitpose.DIMS
    gain = lambda n: SCENE["heat_gain"] if "final_layer" in n else 1.0
    w = _seeded(vitpose.param_shapes(d), 5 * int(seed) + 3, device, gain)
    k1 = torch.tensor(BILINEAR, device=device)
    for i in (0, 3):
        k = f"keypoint_head.deconv_layers.{i}.weight"
        w[k] = (w[k].mean((2, 3)) * 4.0)[:, :, None, None] * (k1[:, None] * k1[None])
    bias = w["keypoint_head.final_layer.bias"]
    for first in (vitpose.LEFT, vitpose.RIGHT):
        bias[first:first + 21] = SCENE["hand_conf"][1]
        bias[first:first + SCENE["hand_valid"]] = SCENE["hand_conf"][0]
    return {"vitpose." + k: v for k, v in w.items()}


def make_weights(seed: int, device, dtype: torch.dtype,
                 fields: Dict) -> Dict[str, torch.Tensor]:
    out = _detector_weights(seed, device, fields["input_size"])
    out.update(_pose_weights(seed, device))
    out.update(HAMER._hamer_weights(seed, device))
    return {k: v.to(dtype).contiguous() for k, v in out.items()}


def offsets_of(shape) -> np.ndarray:
    """The square the resized frame fills, as the program's offsets."""
    h, w = shape[:2]
    side = max(h, w)
    return np.array([side, side, 0, 0, 0, 0, 0, side - w, side - h, 0], np.float64)


class Reference:
    """The reference over one configuration (``archs/acr.py``'s
    ``Reference`` for the meaning of ``tf32`` and ``tail_bf16``, which
    here cover every network's products and HaMeR's tail)."""

    def __init__(self, weights: Dict[str, torch.Tensor], model: Dict,
                 mano_dir: str, device, tf32: bool = False,
                 tail_bf16: bool = False):
        part = lambda p: {k[len(p):]: v.float() for k, v in weights.items()
                          if k.startswith(p)}
        self.D, self.P, self.W = part("vitdet."), part("vitpose."), part("hamer.")
        self.cfg, self.device, self.tf32 = model, device, tf32
        self.tail_bf16 = tail_bf16
        self.mano_r = hamer.load_mano(mano_dir, device)
        right = self.mano_r["faces"]
        self.faces = np.stack([np.ascontiguousarray(right[:, ::-1]), right])

    def _frame(self, bgr: np.ndarray, pick: Optional[Dict]) -> Dict:
        """One frame's detector, pose and hands; ``pick`` the program's
        choices."""
        size, dev = self.cfg["input_size"], self.device
        rgb = torch.as_tensor(np.ascontiguousarray(bgr[:, :, ::-1]), device=dev)
        with torch.no_grad(), fp32_math(self.tf32):
            det = vitdet.detect(self.D, rgb, size, vitdet.DIMS)
            if pick is not None and int(np.asarray(pick["persons"]).reshape(-1)[0]):
                det = self._take_proposal(det, torch.as_tensor(
                    pick["person_roi"], device=dev, dtype=torch.float32).reshape(4))
        resized = det["resized"]
        h, w = bgr.shape[:2]
        sx, sy = w / resized.shape[2], h / resized.shape[1]
        persons = [(s, r) for s, c, r in det["detections"]
                   if c == 0 and s > 0.5]
        out = {"persons": len(persons), "resized": resized}
        score, r = persons[0] if persons else (0.0, None)
        if pick is not None and persons:
            near = _near(det["rois"], torch.as_tensor(pick["person_roi"], device=dev))
            for j in torch.nonzero(near)[:, 0].tolist():
                theirs = float(det["probs"][j, 0])
                if theirs >= score - SCORE_GAP:
                    score, r = theirs, j
                    break
        found = r is not None
        box = det["boxes"][r].double().cpu().numpy() if found else np.zeros(4)
        box = np.clip(box * [sx, sy, sx, sy], 0, [w, h, w, h])
        pd = vitpose.DIMS
        center, scale = vitpose.center_scale(box, pd)
        crop = vitpose.crop(resized, center, scale, (sx, sy), pd)[None]
        with torch.no_grad(), fp32_math(self.tf32):
            heat = vitpose.heatmaps(self.P, crop, pd)[0].double().cpu().numpy()
        kp = vitpose.decode(heat, center, scale, pd.dark_kernel,
                            None if pick is None else np.asarray(pick["kp_argmax"]),
                            HEAT_GAP, None if pick is None else pick["keypoints"])
        hkp, valid, detected = vitpose.hands(kp["keypoints"], kp["confidence"], found)
        if pick is not None:
            c = np.stack([kp["confidence"][vitpose.LEFT:vitpose.LEFT + 21],
                          kp["confidence"][vitpose.RIGHT:vitpose.RIGHT + 21]])
            near = np.abs(c - vitpose.KP_CONF) < CONF_GAP
            valid = np.where(near, np.asarray(pick["hand_valid"], bool), valid) & found
            detected = valid.sum(-1) > vitpose.MIN_VALID
        hkp_in = hkp / np.array([sx, sy])
        out.update(person_box=box, person_score=score, found=found,
                   person_roi=(det["rois"][r].cpu().numpy() if found else np.zeros(4)),
                   keypoints=kp["keypoints"], kp_conf=kp["confidence"],
                   kp_argmax=kp["argmax"],
                   hand_kp=hkp_in, hand_valid=valid,
                   detected=detected,
                   det_boxes=vitpose.hand_boxes(hkp_in, valid, hamer.DIMS))
        return out

    def _take_proposal(self, det: Dict, roi: torch.Tensor) -> Dict:
        """``det`` with the program's first-stage proposal ``roi`` among
        its RoIs, where the reference does not hold it but holds the
        anchor that proposes it and keeps it once that anchor's objectness
        is ``RPN_GAP`` higher and its box is suppressed only above an IoU
        ``IOU_GAP`` higher: a near-tie of the per-level top-k or of the
        NMS. Else ``det`` as it is."""
        if _near(det["rois"], roi).any():
            return det
        hw = tuple(det["resized"].shape[1:])
        for lv, (logits, deltas, anchors) in enumerate(det["levels"]):
            boxes = vitdet.clip(vitdet.decode(deltas, anchors, (1.0,) * 4), hw)
            for i in torch.nonzero(_near(boxes, roi))[:, 0].tolist():
                taken = vitdet.redetect(self.D, det, vitdet.DIMS, (lv, i, RPN_GAP, IOU_GAP))
                if _near(taken["rois"], roi).any():
                    say(f"judge: the program's proposal {roi.tolist()} taken at level {lv}, "
                        f"objectness {float(logits[i])!r}; the reference's cut "
                        f"{float(logits.sort(descending=True).values[min(vitdet.DIMS.pre_nms, len(logits)) - 1])!r}, "
                        f"the IoU and objectness of its proposals over it {_overlapping(det, boxes[i])}")
                    return taken
        return det

    def sequence(self, frames: Sequence[np.ndarray],
                 picks: Optional[Sequence[Dict]] = None,
                 boxes: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Frames in the program's order -> per frame the reference's
        outputs: the detector with ``picks`` (the program's choices) or
        its own, HaMeR on ``boxes`` (T, 2, 3) or on its own boxes."""
        cfg, d, dev = self.cfg, hamer.DIMS, self.device
        size = cfg["input_size"]
        per, params = [], []
        for b0 in range(0, len(frames), BLOCK):
            block = [self._frame(f, None if picks is None else picks[b0 + i])
                     for i, f in enumerate(frames[b0:b0 + BLOCK])]
            crops = []
            for i, fr in enumerate(block):
                use = fr["det_boxes"] if boxes is None else boxes[b0 + i]
                img = fr["resized"].permute(1, 2, 0)
                crops += [vitpose.hand_crop(img, use[h], h == 0, d, dev)
                          for h in range(2)]
                fr["boxes"] = np.asarray(use, np.float64)
            with torch.no_grad(), fp32_math(self.tf32):
                params.append(hamer.regress(self.W, torch.stack(crops), d)
                              .reshape(len(block), 2, -1).cpu())
            for fr in block:
                del fr["resized"]
            per += block
        n = len(frames)
        seq = {k: np.stack([np.asarray(f[k]) for f in per]) for k in per[0]}
        p = torch.cat(params).double()
        rot = hamer.rot6d_to_rotmat(p[..., :96].reshape(n, 2, 16, 6))
        poses = parse.rotmat_to_axis_angle(rot).reshape(n, 2, 48)
        betas = p[..., 96:106]
        detected = torch.as_tensor(seq["detected"])
        if cfg["temporal_optimization"]:
            poses, betas = temporal.smooth(poses, betas, detected, cfg["smooth_coeff"])
        rot = parse.axis_angle_to_rotmat(poses.reshape(2 * n, 16, 3)).to(dev)
        verts, j3d = hamer.mano_forward(self.mano_r, rot, betas.reshape(2 * n, 10).to(dev))
        mirror = torch.tensor([[-1.0, 1.0, 1.0], [1.0, 1.0, 1.0]],
                              dtype=torch.float64)[None, :, None]
        r = self._round
        verts = r(verts.cpu().reshape(n, 2, -1, 3) * mirror)
        j3d = r(j3d.cpu().reshape(n, 2, -1, 3) * mirror)
        cam = p[..., 106:109] * torch.tensor([[1.0, -1.0, 1.0], [1.0, 1.0, 1.0]],
                                             dtype=torch.float64)
        focal = hamer.FOCAL / d.crop * size
        trans = r(hamer.cam_crop_to_full(cam, torch.as_tensor(seq["boxes"]), size, focal))
        placed = j3d + trans[:, :, None]
        pj2d = r(focal * placed[..., :2] / placed[..., 2:] / (size / 2.0))
        offsets = torch.as_tensor(np.stack([offsets_of(f.shape) for f in frames]))
        seq.update(verts=verts.numpy(), j3d=j3d.numpy(), cam_trans=trans.numpy(),
                   pj2d_org=r(camera.to_original(pj2d, offsets[:, None])).numpy(),
                   hamer_params=p.numpy(), offsets=offsets.numpy())
        return seq

    def _round(self, t: torch.Tensor) -> torch.Tensor:
        return t.bfloat16().double() if self.tail_bf16 else t

    def composite(self, ref: Dict[str, np.ndarray], t: int, geometry: Dict,
                  bgr: np.ndarray) -> np.ndarray:
        """The meshes rendered over the frame: the square render at
        ``render_size`` cut to the frame's corner and resized onto it."""
        import cv2
        dev = self.device
        rgba = render.render(
            torch.as_tensor(geometry["verts"], device=dev),
            torch.as_tensor(geometry["cam_trans"], device=dev),
            geometry["detection_flag"], self.faces, self.cfg["render_size"],
            float(self.cfg["focal_length"]), bf16=self.tail_bf16)
        side = int(ref["offsets"][t][0])
        rgba = cv2.resize(np.asarray(rgba, np.float32), (side, side),
                          interpolation=cv2.INTER_LINEAR)[:bgr.shape[0], :bgr.shape[1]]
        alpha = rgba[..., 3:4] / 255.0
        out = bgr[:, :, ::-1] * (1 - alpha) + rgba[..., :3] * alpha
        return np.clip(out + 0.5, 0, 255).astype(np.uint8)[:, :, ::-1]


def _near(boxes: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Which of ``boxes`` (N, 4) lie within ``ROI_MATCH`` of ``box``."""
    return (boxes - box).abs().max(-1).values < ROI_MATCH


def _overlapping(det: Dict, box: torch.Tensor) -> List[tuple]:
    """(IoU, objectness) of ``det``'s proposals that overlap ``box`` by
    more than the RPN's NMS threshold."""
    iou = vitdet.iou(torch.cat([box[None], det["rois"]]))[0, 1:]
    return [(float(iou[j]), float(det["objectness"][j]))
            for j in np.nonzero(iou > vitdet.DIMS.rpn_nms)[0]]


def new_numbers() -> Dict[str, float]:
    return {"hands_wrong": 0.0, "persons_wrong": 0.0, "kp_valid_wrong": 0.0,
            "det_box_px": 0.0, "det_score_err": 0.0, "kp_px": 0.0,
            "kp_conf_err": 0.0, "box_px": 0.0, "params_err": 0.0, "verts_m": 0.0,
            "cam_mesh_m": 0.0, "pj2d_px": 0.0}


def _hand(a: np.ndarray) -> np.ndarray:
    """The 42 hand keypoints' rows of a (133, ...) array."""
    return np.concatenate([a[vitpose.LEFT:vitpose.LEFT + 21],
                           a[vitpose.RIGHT:vitpose.RIGHT + 21]])


def judge_sequence(ref_model: Reference, frames: Sequence[np.ndarray],
                   outputs: List[Dict], judged: Sequence[int],
                   composites: Dict[int, np.ndarray],
                   numbers: Dict[str, float], fields: Dict) -> Dict:
    """Add one sequence's readings to ``numbers`` (widest wins); returns
    the reference's outputs (``archs/acr.py``'s ``judge_sequence`` for the
    arguments)."""
    ref = ref_model.sequence(frames, outputs, np.stack([o["boxes"] for o in outputs]))
    widest = lambda name, a, b: numbers.__setitem__(name, max(
        numbers[name], float(np.abs(np.asarray(a, np.float64) - b).max(initial=0.0))))
    for t in judged:
        o = outputs[t]
        if int(np.asarray(o["persons"]).reshape(-1)[0]) != ref["persons"][t]:
            numbers["persons_wrong"] += 1
            continue
        numbers["kp_valid_wrong"] += float(
            (np.asarray(o["hand_valid"], bool) != ref["hand_valid"][t]).sum())
        det = np.asarray(o["detection_flag"]).astype(bool)
        if (det != ref["detected"][t]).any():
            numbers["hands_wrong"] += 1
            continue
        widest("det_box_px", o["person_box"], ref["person_box"][t])
        widest("det_score_err", o["person_score"], ref["person_score"][t])
        valid = _hand(ref["kp_conf"][t]) > vitpose.KP_CONF
        widest("kp_px", _hand(o["keypoints"])[valid], _hand(ref["keypoints"][t])[valid])
        widest("kp_conf_err", _hand(o["kp_conf"]), _hand(ref["kp_conf"][t]))
        if not det.any():
            continue
        widest("box_px", o["boxes"][det], ref["det_boxes"][t][det])
        widest("params_err", o["hamer_params"][det], ref["hamer_params"][t][det])
        widest("verts_m", o["verts"][det], ref["verts"][t][det])
        seen = det[:, None] & ((ref["j3d"][t] + ref["cam_trans"][t][:, None])[..., 2] >= NEAR_M)
        widest("pj2d_px", o["pj2d_org"][seen], ref["pj2d_org"][t][seen])
        widest("cam_mesh_m", (o["verts"] + o["cam_trans"][:, None])[det],
               (ref["verts"][t] + ref["cam_trans"][t][:, None])[det])
    for t, delivered in composites.items():
        drawn = ref_model.composite(ref, t, outputs[t], frames[t])
        off = np.abs(delivered.astype(np.int16) - drawn.astype(np.int16)) > LEVELS
        numbers["composite_off"] = numbers.get("composite_off", 0.0) + float(off.sum())
    return ref


def as_outputs(ref_out: Dict[str, np.ndarray], t: int, fields: Dict) -> Dict:
    """Frame ``t`` of ``Reference.sequence``'s outputs as the program's
    host outputs of that frame."""
    return {"verts": ref_out["verts"][t], "j3d": ref_out["j3d"][t],
            "pj2d_org": ref_out["pj2d_org"][t], "cam_trans": ref_out["cam_trans"][t],
            "boxes": ref_out["boxes"][t], "hamer_params": ref_out["hamer_params"][t],
            "detection_flag": ref_out["detected"][t],
            "person_box": ref_out["person_box"][t],
            "person_score": ref_out["person_score"][t],
            "person_roi": ref_out["person_roi"][t],
            "persons": np.array([ref_out["persons"][t]]),
            "keypoints": ref_out["keypoints"][t], "kp_conf": ref_out["kp_conf"][t],
            "kp_argmax": ref_out["kp_argmax"][t], "hand_valid": ref_out["hand_valid"][t]}


def _meta(spec) -> Dict[str, torch.Tensor]:
    return {n: torch.empty(s, device="meta") for n, s in spec}


@functools.lru_cache(maxsize=None)
def _detector_flops(d: vitdet.Dims, p: vitpose.Dims, size: int) -> Dict[str, int]:
    from torch.utils.flop_counter import FlopCounterMode
    w = _meta(vitdet.param_shapes(d, size))
    pw = _meta(vitpose.param_shapes(p))
    parts = {}

    def count(name, fn):
        with FlopCounterMode(display=False) as counter:
            out = fn()
        parts[name] = int(counter.get_total_flops())
        return out
    x = torch.empty((1, 3, size, size), device="meta")
    top = count("backbone", lambda: vitdet.backbone(w, x, d))
    feats = count("pyramid", lambda: vitdet.pyramid(w, top))
    r = "proposal_generator.rpn_head."

    def rpn_convs():
        for f in feats:
            for k in range(2):
                f = torch.nn.functional.conv2d(f, w[f"{r}conv.conv{k}.weight"], padding=1)
            torch.nn.functional.conv2d(f, w[r + "objectness_logits.weight"])
            torch.nn.functional.conv2d(f, w[r + "anchor_deltas.weight"])
    count("rpn", rpn_convs)
    pooled = torch.empty((d.post_nms, d.fpn, d.pooled, d.pooled), device="meta")

    def heads():
        for k in range(len(d.cascade)):
            y = vitdet.box_head(w, pooled, k, d)
            q = f"roi_heads.box_predictor.{k}."
            vitdet._linear(y, w, q + "cls_score")
            vitdet._linear(y, w, q + "bbox_pred")
    count("cascade", heads)
    crops = torch.empty((1, 3, p.vit.crop, p.vit.crop_w), device="meta")
    count("pose", lambda: vitpose.heatmaps(pw, crops, p))
    return parts


def detector_flops_parts() -> Dict[str, int]:
    """The detector's FLOPs per frame at the published widths, by part."""
    return dict(_detector_flops(vitdet.Dims(), vitpose.Dims(), 1024))


def detector_flops() -> int:
    return sum(detector_flops_parts().values())


def flops_per_frame(fields: Dict) -> int:
    """The detector chain's and HaMeR's on two crops."""
    size = fields["input_size"]
    return sum(_detector_flops(vitdet.DIMS, vitpose.DIMS, size).values()) + \
        HAMER._regressor_flops(hamer.DIMS)


def _attend(batch: int, heads: int, n: int, hd: int, bias: bool) -> Dict[str, float]:
    return {"flops": 4.0 * batch * heads * n * n * hd,
            "bytes": 4.0 * (4 * batch * heads * n * hd + (batch * heads * n * n if bias else 0))}


def attention_work() -> List[Dict[str, float]]:
    """A frame's fp32 attention launches at the published widths (q k^T
    and the weighted sum of v, a multiply-add as two; q, k, v and the
    output, and the bias where there is one, each moved once): ViTDet's
    28 windowed blocks (25 windows of 196 tokens) and 4 global ones (4096
    tokens), ViTPose's 32 blocks and HaMeR's ViT's 32 on two crops of 192
    tokens each. HaMeR's decoder (head width 64) is not counted."""
    d, p = vitdet.Dims(), vitpose.Dims()
    hd = d.width // d.heads
    grid = 1024 // d.patch
    windows = (-(-grid // d.window)) ** 2
    tokens = (p.vit.crop // p.vit.patch) * (p.vit.crop_w // p.vit.patch)
    out = [_attend(windows, d.heads, d.window ** 2, hd, True)] * (d.depth - len(d.global_blocks))
    out += [_attend(1, d.heads, grid * grid, hd, True)] * len(d.global_blocks)
    out += [_attend(2, p.vit.heads, tokens, p.vit.width // p.vit.heads, False)] * (
        p.vit.depth + hamer.Dims().depth)
    return out


def nms_work() -> List[Dict[str, float]]:
    """A frame's NMS launches: the RPN's 5 levels and the box head's 80
    classes, 1000 boxes each (boxes and flags read, flags written; every
    pair's IoU, 14 operations)."""
    d = vitdet.Dims()
    return [{"bytes": s * d.pre_nms * 18.0, "flops": 14.0 * s * d.pre_nms * (d.pre_nms - 1) / 2}
            for s in (len(d.anchor_sizes), d.classes)]


def roi_align_work() -> List[Dict[str, float]]:
    """A frame's ROIAlignV2 launches, one a stage over 1000 RoIs: the
    output written once, one bilinear sample (10 operations) per output."""
    d = vitdet.Dims()
    outs = d.post_nms * d.fpn * d.pooled * d.pooled
    return [{"bytes": 4.0 * outs, "flops": 10.0 * outs}] * len(d.cascade)


def bound_s(work: List[Dict[str, float]], peaks: Dict) -> float:
    """The least time of a list of launches on the card."""
    return sum(max(w["flops"] / peaks["fp32"], w["bytes"] / peaks["bytes_s"]) for w in work)
