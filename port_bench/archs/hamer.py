"""HaMeR (arXiv 2312.05251) on ACR's detections: what of a run is the
architecture's.

The configuration's ``"architecture": "hamer"`` names this file. The
program detects both hands with ACR (the network, the centres and
parameters, MANO, the weak-perspective joints ``pj2d``), boxes each hand
from its 21 joints as HaMeR's demo does, crops the 512 px input on the
device and regresses right-hand MANO for each crop with HaMeR (a
ViT-H/16 and a 6-block transformer decoder), the left crop mirrored;
OneEuro filters HaMeR's poses and betas with ``-t``; the crop's camera
is carried to the frame's. ACR's steps (weights, reference detector,
``picks_of``) come from ``archs/acr.py``; HaMeR's from
``reference/hamer.py``.

Weights. ACR's detector with ACR's scene (``archs/acr.py``: both hands
detected on every frame), and HaMeR's own initialisers under the
``hamer.`` prefix: the ViT's and the decoder's linear weights and the
position tables normal of std 0.02 cut at two standard deviations (unit
variance after the cut rescaled, as ``archs/acr.py`` does), the patch
convolution's of std 1 / sqrt(fan-in), biases 0, LayerNorms 1 and 0.
The scene (``SCENE``): the output layers (``decpose``, ``decshape``,
``deccam``) scaled by ``out_gain``, and the mean parameters HaMeR adds
to them set to identity 6D rotations, zero betas and a camera that
fills the crop with the (synthetic) hand, its x offset centring MANO's
mesh, so that both hands stay in view near the mean pose and move with
the crop.

Judge. The reference recomputes every frame the program processed, in
the program's order: ACR's network at the program's centres (as
``archs/acr.py`` does), the detector's unsmoothed joints and their
boxes; then HaMeR on crops of the program's own boxes (as the composite
is judged on the program's geometry, so that a box a fraction of a
pixel off does not move every number after it), in fp32 with TF32 off,
in blocks of frames; the rotations to axis-angle; OneEuro over the
sequence; MANO; the camera. Numbers, each the widest over the judged
frames and both hands: ``hands_wrong``, ``center_gap`` and
``center_err`` (ACR's), ``box_px`` (the program's boxes against the
reference detector's, pixels of the input), ``params_err`` (HaMeR's 109
regressed numbers), ``verts_m``, ``cam_mesh_m``, ``pj2d_px`` and, where
frames were delivered with the render, ``composite_off``, as ACR's.

Work. ``flops_per_frame``: ``FlopCounterMode`` on the meta device over
the reference detector and HaMeR on two crops. ``regressor_flops`` and
``attention_work`` at the published widths, for the metrics of the
regress stage and of the attention kernel.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from port_bench.harness import manifest
from port_bench.harness.judge import BLOCK, LEVELS, fp32_math
from port_bench.reference import camera, hamer, host, mano, network, parse, render, temporal

ACR = manifest.load_arch("acr")

SCENE = {"cam": (4.0, -0.38, 0.0), "rot6d": (1.0, 0.0, 0.0, 0.0, 1.0, 0.0),
         "out_gain": 0.25}

KEEP = ("verts", "j3d", "pj2d_org", "cam_trans", "centers", "centers_conf",
        "boxes", "hamer_params", "detection_flag")

# a truncated normal of unit variance after the cut at two standard deviations
_TRUNC = 0.87962566103423978


def _hamer_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    d = hamer.DIMS
    spec = hamer.param_shapes(d)
    gen = torch.Generator(device=device)
    gen.manual_seed((2 * int(seed) + 1) % (2 ** 63))
    random = [(n, s) for n, s in spec
              if n.endswith(("weight", "pos_embed", "pos_embedding"))
              and "norm" not in n]
    total = sum(math.prod(s) for _, s in random)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in random:
        n = math.prod(shape)
        std = 1.0 / math.sqrt(math.prod(shape[1:])) if len(shape) == 4 else 0.02
        if name.startswith("mano_head.dec"):
            std *= SCENE["out_gain"]
        out[name] = flat[at:at + n].view(shape).clamp_(-2.0, 2.0) * (std / _TRUNC)
        at += n
    del flat
    for name, shape in spec:
        if name in out:
            continue
        t = torch.zeros(shape, device=device)
        if "norm" in name and name.endswith("weight"):
            t.fill_(1.0)
        elif name.endswith("init_hand_pose"):
            t[:] = torch.tensor(SCENE["rot6d"], device=device).repeat(16)
        elif name.endswith("init_cam"):
            t[:] = torch.tensor(SCENE["cam"], device=device)
        out[name] = t
    return {"hamer." + k: v for k, v in out.items()}


def make_weights(seed: int, device, dtype: torch.dtype,
                 fields: Dict) -> Dict[str, torch.Tensor]:
    out = ACR.make_weights(seed, device, dtype, fields)
    out.update({k: v.to(dtype).contiguous()
                for k, v in _hamer_weights(seed, device).items()})
    return out


class Reference:
    """The reference over one configuration (``archs/acr.py``'s
    ``Reference`` for the meaning of ``tf32`` and ``tail_bf16``, which
    here also cover HaMeR's products and its tail)."""

    def __init__(self, weights: Dict[str, torch.Tensor], model: Dict,
                 mano_dir: str, device, tf32: bool = False,
                 tail_bf16: bool = False):
        self.P = network.Params({k: v.float() for k, v in weights.items()
                                 if not k.startswith("hamer.")})
        self.W = {k[len("hamer."):]: v.float() for k, v in weights.items()
                  if k.startswith("hamer.")}
        self.cfg, self.device, self.tf32 = model, device, tf32
        self.tail_bf16 = tail_bf16
        self.mano = [mano.load(mano_dir, s, device) for s in ("left", "right")]
        self.mano_r = hamer.load_mano(mano_dir, device)
        right = self.mano_r["faces"]
        self.faces = np.stack([np.ascontiguousarray(right[:, ::-1]), right])

    def sequence(self, frames: Sequence[np.ndarray],
                 picks: Optional[np.ndarray] = None,
                 boxes: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Frames in the program's order -> per frame the reference's
        outputs, the detector at ``picks`` (T, 2) or its own best cells,
        HaMeR on ``boxes`` (T, 2, 3) or on its detector's boxes."""
        cfg, d, dev = self.cfg, hamer.DIMS, self.device
        size = cfg["input_size"]
        parts = []
        for b0 in range(0, len(frames), BLOCK):
            prepped = [host.preprocess(f, size) for f in frames[b0:b0 + BLOCK]]
            image = torch.as_tensor(np.stack([p[0] for p in prepped]), device=dev)
            with torch.no_grad(), fp32_math(self.tf32):
                maps = network.forward(self.P, image)
            pk = None if picks is None else torch.as_tensor(
                picks[b0:b0 + BLOCK], device=dev)
            out = parse.parse(maps, cfg["centermap_conf_thresh"],
                              cfg["prior_gate_px"], picks=pk)
            best = torch.stack([
                maps[f"{s}_center_map"][..., 0].flatten(1).amax(1)
                for s in "lr"], 1)
            out["gap"] = best - out["score"]
            # the detector's joints as the program boxes them: MANO on the
            # unsmoothed parameters, the weak-perspective camera
            j3d = torch.stack([mano.forward(self.mano[h], out["poses"][:, h],
                                            out["betas"][:, h])[1]
                               for h in range(2)], 1)
            pj = camera.weak_persp(j3d, out["cam"].double())
            out["det_boxes"] = torch.as_tensor(
                hamer.boxes(((pj + 1) * (size / 2.0)).cpu().numpy(), d))
            use = out["det_boxes"].numpy() if boxes is None else boxes[b0:b0 + BLOCK]
            crops = torch.stack([hamer.crop(image[i], use[i, h], h == 0, d, dev)
                                 for i in range(len(prepped)) for h in range(2)])
            with torch.no_grad(), fp32_math(self.tf32):
                out["hamer_params"] = hamer.regress(self.W, crops, d).reshape(
                    len(prepped), 2, -1)
            out["boxes"] = torch.as_tensor(np.asarray(use, np.float64))
            out["offsets"] = torch.as_tensor(np.stack([p[1] for p in prepped]))
            out["image"] = image
            parts.append({k: v.cpu() for k, v in out.items()})
        seq = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        n = len(frames)
        p = seq["hamer_params"].double()
        rot = hamer.rot6d_to_rotmat(p[..., :96].reshape(n, 2, 16, 6))
        poses = parse.rotmat_to_axis_angle(rot).reshape(n, 2, 48)
        betas = p[..., 96:106]
        if cfg["temporal_optimization"]:
            poses, betas = temporal.smooth(poses, betas, seq["detected"],
                                           cfg["smooth_coeff"])
        rot = parse.axis_angle_to_rotmat(poses.reshape(2 * n, 16, 3)).to(dev)
        verts, j3d = hamer.mano_forward(self.mano_r, rot,
                                        betas.reshape(2 * n, 10).to(dev))
        mirror = torch.tensor([[-1.0, 1.0, 1.0], [1.0, 1.0, 1.0]],
                              dtype=torch.float64)[None, :, None]
        r = self._round
        verts = r(verts.cpu().reshape(n, 2, -1, 3) * mirror)
        j3d = r(j3d.cpu().reshape(n, 2, -1, 3) * mirror)
        cam = p[..., 106:109] * torch.tensor([[1.0, -1.0, 1.0], [1.0, 1.0, 1.0]],
                                             dtype=torch.float64)
        focal = hamer.FOCAL / d.crop * size
        trans = r(hamer.cam_crop_to_full(cam, seq["boxes"], size, focal))
        placed = j3d + trans[:, :, None]
        pj2d = r(focal * placed[..., :2] / placed[..., 2:] / (size / 2.0))
        return {"verts": verts.numpy(), "j3d": j3d.numpy(),
                "pj2d_org": r(camera.to_original(
                    pj2d, seq["offsets"].double()[:, None])).numpy(),
                "cam_trans": trans.numpy(), "detected": seq["detected"].numpy(),
                "gap": seq["gap"].numpy(), "flat": seq["flat"].numpy(),
                "score": seq["score"].numpy(), "boxes": seq["boxes"].numpy(),
                "det_boxes": seq["det_boxes"].numpy(),
                "hamer_params": seq["hamer_params"].numpy(),
                "image": seq["image"].numpy(), "offsets": seq["offsets"].numpy()}

    def _round(self, t: torch.Tensor) -> torch.Tensor:
        return t.bfloat16().double() if self.tail_bf16 else t

    def composite(self, ref: Dict[str, np.ndarray], t: int, geometry: Dict,
                  bgr: np.ndarray) -> np.ndarray:
        """As ``archs/acr.py``'s, with HaMeR's faces."""
        dev = self.device
        rgba = render.render(
            torch.as_tensor(geometry["verts"], device=dev),
            torch.as_tensor(geometry["cam_trans"], device=dev),
            geometry["detection_flag"], self.faces, self.cfg["render_size"],
            float(self.cfg["focal_length"]), bf16=self.tail_bf16)
        return host.composite(rgba, ref["image"][t], bgr, ref["offsets"][t])


def new_numbers() -> Dict[str, float]:
    return {"hands_wrong": 0.0, "center_gap": 0.0, "center_err": 0.0,
            "box_px": 0.0, "params_err": 0.0, "verts_m": 0.0,
            "cam_mesh_m": 0.0, "pj2d_px": 0.0}


def judge_sequence(ref_model: Reference, frames: Sequence[np.ndarray],
                   outputs: List[Dict], judged: Sequence[int],
                   composites: Dict[int, np.ndarray],
                   numbers: Dict[str, float], fields: Dict) -> Dict:
    """Add one sequence's readings to ``numbers`` (widest wins); returns
    the reference's outputs (``archs/acr.py``'s ``judge_sequence`` for the
    arguments)."""
    ref = ref_model.sequence(frames, ACR.picks_of(outputs, fields["centermap_size"]),
                             np.stack([o["boxes"] for o in outputs]))
    widest = lambda name, a, b: numbers.__setitem__(name, max(
        numbers[name], float(np.abs(a - b).max())))
    for t in judged:
        o = outputs[t]
        det = np.asarray(o["detection_flag"]).astype(bool)
        if not det.all() or (det != ref["detected"][t]).any():
            numbers["hands_wrong"] += 1
            continue
        numbers["center_gap"] = max(numbers["center_gap"],
                                    float(ref["gap"][t].max()))
        widest("center_err", o["centers_conf"], ref["score"][t])
        widest("box_px", o["boxes"], ref["det_boxes"][t])
        widest("params_err", o["hamer_params"], ref["hamer_params"][t])
        widest("verts_m", o["verts"], ref["verts"][t])
        widest("pj2d_px", o["pj2d_org"], ref["pj2d_org"][t])
        widest("cam_mesh_m", o["verts"] + o["cam_trans"][:, None],
               ref["verts"][t] + ref["cam_trans"][t][:, None])
    for t, delivered in composites.items():
        drawn = ref_model.composite(ref, t, outputs[t], frames[t])
        off = np.abs(delivered.astype(np.int16) - drawn.astype(np.int16)) > LEVELS
        numbers["composite_off"] = numbers.get("composite_off", 0.0) + float(off.sum())
    return ref


@functools.lru_cache(maxsize=None)
def _regressor_flops(d: hamer.Dims) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    w = {n: torch.empty(s, device="meta") for n, s in hamer.param_shapes(d)}
    crops = torch.empty((2, 3, d.crop, d.crop_w), device="meta")
    with FlopCounterMode(display=False) as counter:
        hamer.regress(w, crops, d)
    return int(counter.get_total_flops())


def regressor_flops() -> int:
    """HaMeR's FLOPs for a frame's two crops at the published widths
    (convolution and matrix products, a multiply-add as two)."""
    return _regressor_flops(hamer.Dims())


def attention_work() -> Dict[str, float]:
    """One ViT attention launch at the published widths over a frame's two
    crops: ``flops`` (q k^T and the weighted sum of v, a multiply-add as
    two) and ``bytes`` (q, k, v read and the output written once, fp32)."""
    d = hamer.Dims()
    tokens = (d.crop // d.patch) * (d.crop_w // d.patch)
    hd = d.width // d.heads
    return {"flops": 2 * d.heads * tokens * tokens * hd * 4,
            "bytes": 4 * 4 * 2 * d.heads * tokens * hd}


def flops_per_frame(fields: Dict) -> int:
    """The detector's (``archs/acr.py``) and HaMeR's on two crops."""
    return ACR.flops_per_frame(fields) + _regressor_flops(hamer.DIMS)


def as_outputs(ref_out: Dict[str, np.ndarray], t: int, fields: Dict) -> Dict:
    """Frame ``t`` of ``Reference.sequence``'s outputs as the program's
    host outputs of that frame."""
    w = fields["centermap_size"]
    flat = ref_out["flat"][t]
    return {"verts": ref_out["verts"][t], "j3d": ref_out["j3d"][t],
            "pj2d_org": ref_out["pj2d_org"][t],
            "cam_trans": ref_out["cam_trans"][t],
            "centers": np.stack([flat % w, flat // w], -1),
            "centers_conf": ref_out["score"][t], "boxes": ref_out["boxes"][t],
            "hamer_params": ref_out["hamer_params"][t],
            "detection_flag": ref_out["detected"][t]}
