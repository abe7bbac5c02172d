"""ACR (arXiv 2303.05938): what of a run is the architecture's.

The configuration's ``"architecture": "acr"`` names this file; the
harness loads it by path (``harness.manifest.load_arch``) and reaches
everything below only through it. The architecture's steps: the seeded
weights and their scene (``make_weights``), the output keys the drivers
keep (``KEEP``), the frozen reference over a sequence (``Reference``:
the HRNet-W32 network with ACR's heads, the centres and sampled
parameters, OneEuro, MANO, the camera, the render and the composite, all
from ``port_bench/reference/``), the judge's numbers (``new_numbers``,
``judge_sequence``), the network's FLOPs per frame (``flops_per_frame``)
and the program-shaped outputs of a reference put in the program's place
(``as_outputs``). The harness's steps: the drivers, the window, the
trace, the verdict over the configuration's ``limits`` and the
rasterizer's and MANO kernel's work.

Weights. Rules (flax's initialisers, as the port's own random
checkpoints use them): conv and dense kernels normal of variance 1 /
fan-in, cut at two standard deviations; the locally connected head's
kernel normal(1); biases 0. Folded-BN scales are 1 on the paths that
carry the signal (every ``ConvBN`` and the projection shortcut) and 0.2
inside the residual branches (``bn1``..``bn3``), so that the activations
stay finite and the features that reach the heads follow the frame (with
0.2 everywhere the CoordConv channels drown the image by some 1e4 and
every frame gives the same hands). Then the "near" scene: the 1x1 fuse
convs that emit each hand's 109 parameters and the prior heads' output
convs are damped by 0.005, the fuse biases set to the camera (5, -+0.3,
0), identity 6D rotations at five times unit length (the 6D columns are
normalised, so the rotations stay well away from the representation's
singular columns and from pi) and zero betas, and the centre heads'
output kernels scaled by 0.1 and raised by 1.5, so both hands are
detected on every frame, posed around MANO's mean pose, and move from
frame to frame with the image. The weights are made on the device in a
few large calls and returned in the dtype they are served in.

Judge. The reference recomputes every frame the program processed, in
the program's order, from the same frames and weights: the network in
fp32 with TF32 off (in blocks of frames), the centres, the sampled
parameters, the OneEuro filter over the sequence, MANO, the camera and,
for a sample of delivered frames, the render and the composite. Where
the program picked another centre cell than the reference's best, the
reference samples at the program's cell and ``center_gap`` records by
how much the reference's own map ranks that cell below its best: a
near-tie in the program's precision is no fault, a wider gap is.

Numbers, each the widest over the judged frames and both hands:
``hands_wrong`` (frames whose detections are not both hands, or differ
from the reference's at the same cells; exact), ``center_gap`` (centre
map units), ``center_err`` (the centre map's value at the picked cell),
``params_err`` (the 109 sampled, prior-fused parameters), ``verts_m``
(root-aligned mesh vertices, metres), ``cam_mesh_m`` (the vertices
placed by the camera translation, as the render places them, metres),
``pj2d_px`` (2D joints in the original frame, pixels) and, where frames
were delivered with the render,
``composite_off``: the count of values of the sampled delivered frames
more than ``LEVELS`` from the reference's render and composite of the
program's own geometry. The render stage is judged on the program's
geometry (which the other numbers judge on their own), so that the
reference's float32 edge tests meet the same vertices as the program's
kernel; what remains are edge pixels and the shading round-off (MANO's
vertex 767 has faces whose normals nearly cancel).

Which numbers a cell compares, and their limits, is the configuration
file's ``limits``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from port_bench.harness.judge import BLOCK, LEVELS, fp32_math
from port_bench.reference import camera, host, mano, network, parse, render, temporal

SCENE = {"cam": (5.0, 0.3, 0.0), "rot6d": 5.0, "fuse_gain": 0.005,
         "prior_gain": 0.005, "center_gain": 0.1, "center_bias": 1.5,
         "bn_signal": 1.0, "bn_residual": 0.2}

KEEP = ("verts", "j3d", "pj2d_org", "cam_trans", "centers", "centers_conf",
        "params", "detection_flag")


def make_weights(seed: int, device, dtype: torch.dtype,
                 fields: Dict) -> Dict[str, torch.Tensor]:
    spec = network.param_shapes(fields["input_size"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    random = [(n, s) for n, s in spec if n.endswith((".weight", ".w"))]
    total = sum(math.prod(s) for _, s in random)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in random:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if name.endswith(".weight"):
            # unit variance after the cut at 2 sigma: std / 0.8796
            t = t.clamp(-2.0, 2.0) * (math.sqrt(1.0 / math.prod(shape[1:]))
                                      / 0.87962566103423978)
        out[name] = t
    for name, shape in spec:
        if name not in out:
            fill = 0.0
            if name.endswith((".bn.scale", ".down_bn.scale")):
                fill = SCENE["bn_signal"]
            elif name.endswith(".scale"):
                fill = SCENE["bn_residual"]
            out[name] = torch.full(shape, fill, device=device)
    cam = SCENE["cam"]
    ident = SCENE["rot6d"] * torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0],
                                          device=device)
    for side, sign in (("l", -1.0), ("r", 1.0)):
        w = out[f"{side}_fuse_conv.weight"] * SCENE["fuse_gain"]
        w[:3] = 0.0
        out[f"{side}_fuse_conv.weight"] = w
        out[f"{side}_fuse_conv.bias"] = torch.cat([
            torch.tensor([cam[0], sign * cam[1], cam[2]], device=device),
            ident.repeat(16), torch.zeros(10, device=device)])
        out[f"{side}_prior_head.out.weight"] = \
            out[f"{side}_prior_head.out.weight"] * SCENE["prior_gain"]
        out[f"{side}_center_head.out.weight"] = \
            out[f"{side}_center_head.out.weight"] * SCENE["center_gain"]
        out[f"{side}_center_head.out.bias"] = \
            out[f"{side}_center_head.out.bias"] + SCENE["center_bias"]
    return {k: v.to(dtype).contiguous() for k, v in out.items()}


class Reference:
    """The reference over one configuration: weights (float32 copies of
    the served values) and MANO on ``device``. A control lowers its
    precision: ``tf32`` (the network's products in TF32) and
    ``tail_bf16`` (MANO, the camera, the translation and the render's
    screen positions rounded to bf16)."""

    def __init__(self, weights: Dict[str, torch.Tensor], model: Dict,
                 mano_dir: str, device, tf32: bool = False,
                 tail_bf16: bool = False):
        self.P = network.Params({k: v.float() for k, v in weights.items()})
        self.cfg, self.device, self.tf32 = model, device, tf32
        self.tail_bf16 = tail_bf16
        self.mano = [mano.load(mano_dir, s, device) for s in ("left", "right")]
        self.faces = np.stack([m["faces"] for m in self.mano])

    def sequence(self, frames: Sequence[np.ndarray],
                 picks: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Frames in the program's order (one OneEuro run) -> per frame
        the reference's outputs at ``picks`` (T, 2) flat cells, or at its
        own best cells."""
        cfg = self.cfg
        size = cfg["input_size"]
        parts = []
        for b0 in range(0, len(frames), BLOCK):
            prepped = [host.preprocess(f, size) for f in frames[b0:b0 + BLOCK]]
            image = torch.as_tensor(np.stack([p[0] for p in prepped]),
                                    device=self.device)
            with torch.no_grad(), fp32_math(self.tf32):
                maps = network.forward(self.P, image)
            pk = None if picks is None else torch.as_tensor(
                picks[b0:b0 + BLOCK], device=self.device)
            out = parse.parse(maps, cfg["centermap_conf_thresh"],
                              cfg["prior_gate_px"], picks=pk)
            best = torch.stack([
                maps[f"{s}_center_map"][..., 0].flatten(1).amax(1)
                for s in "lr"], 1)
            out["gap"] = best - out["score"]
            out["offsets"] = torch.as_tensor(
                np.stack([p[1] for p in prepped]), device=self.device)
            out["image"] = image
            parts.append({k: v.cpu() for k, v in out.items()})
        seq = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        poses, betas = seq["poses"].double(), seq["betas"].double()
        if cfg["temporal_optimization"]:
            poses, betas = temporal.smooth(poses, betas, seq["detected"],
                                           cfg["smooth_coeff"])
        verts, j3d = [], []
        for h in range(2):
            v, j = mano.forward(self.mano[h], poses[:, h].to(self.device),
                                betas[:, h].to(self.device))
            verts.append(v.cpu())
            j3d.append(j.cpu())
        r = self._round
        verts, j3d = r(torch.stack(verts, 1)), r(torch.stack(j3d, 1))
        cam = seq["cam"].double()
        pj2d = r(camera.weak_persp(j3d, cam))
        trans = r(camera.translation(j3d, (pj2d + 1) * (size / 2.0),
                                     float(cfg["focal_length"]), size))
        return {"verts": verts.numpy(), "j3d": j3d.numpy(),
                "pj2d_org": r(camera.to_original(
                    pj2d, seq["offsets"].double()[:, None])).numpy(),
                "cam_trans": trans.numpy(), "detected": seq["detected"].numpy(),
                "gap": seq["gap"].numpy(), "flat": seq["flat"].numpy(),
                "score": seq["score"].numpy(), "params": seq["params"].numpy(),
                "image": seq["image"].numpy(), "offsets": seq["offsets"].numpy()}

    def _round(self, t: torch.Tensor) -> torch.Tensor:
        return t.bfloat16().double() if self.tail_bf16 else t

    def composite(self, ref: Dict[str, np.ndarray], t: int, geometry: Dict,
                  bgr: np.ndarray) -> np.ndarray:
        """The delivered frame the reference draws for frame ``t`` from
        ``geometry`` (verts, cam_trans, detection_flag of one frame), on
        its own input image and offsets."""
        dev = self.device
        rgba = render.render(
            torch.as_tensor(geometry["verts"], device=dev),
            torch.as_tensor(geometry["cam_trans"], device=dev),
            geometry["detection_flag"], self.faces, self.cfg["render_size"],
            float(self.cfg["focal_length"]), bf16=self.tail_bf16)
        return host.composite(rgba, ref["image"][t], bgr, ref["offsets"][t])


def picks_of(outputs: List[Dict], width: int) -> np.ndarray:
    """The program's centre cells (x, y) as flat indices, (T, 2)."""
    c = np.stack([o["centers"] for o in outputs]).astype(np.int64)
    return c[..., 1] * width + c[..., 0]


def new_numbers() -> Dict[str, float]:
    return {"hands_wrong": 0.0, "center_gap": 0.0, "center_err": 0.0,
            "params_err": 0.0, "verts_m": 0.0, "cam_mesh_m": 0.0,
            "pj2d_px": 0.0}


def judge_sequence(ref_model: Reference, frames: Sequence[np.ndarray],
                   outputs: List[Dict], judged: Sequence[int],
                   composites: Dict[int, np.ndarray],
                   numbers: Dict[str, float], fields: Dict) -> Dict:
    """Add one sequence's readings to ``numbers`` (widest wins):
    ``outputs[t]`` the program's host outputs of frame ``t`` (one image,
    hand axis first), ``judged`` the frames to compare, ``composites``
    delivered frames to compare by index. Returns the reference's
    outputs."""
    ref = ref_model.sequence(frames, picks_of(outputs, fields["centermap_size"]))
    for t in judged:
        o = outputs[t]
        det = np.asarray(o["detection_flag"]).astype(bool)
        if not det.all() or (det != ref["detected"][t]).any():
            numbers["hands_wrong"] += 1
            continue
        numbers["center_gap"] = max(numbers["center_gap"],
                                    float(ref["gap"][t].max()))
        numbers["center_err"] = max(numbers["center_err"], float(
            np.abs(o["centers_conf"] - ref["score"][t]).max()))
        numbers["params_err"] = max(numbers["params_err"], float(
            np.abs(o["params"] - ref["params"][t]).max()))
        numbers["verts_m"] = max(numbers["verts_m"], float(
            np.abs(o["verts"] - ref["verts"][t]).max()))
        numbers["pj2d_px"] = max(numbers["pj2d_px"], float(
            np.abs(o["pj2d_org"] - ref["pj2d_org"][t]).max()))
        placed = o["verts"] + o["cam_trans"][:, None]
        ref_placed = ref["verts"][t] + ref["cam_trans"][t][:, None]
        numbers["cam_mesh_m"] = max(numbers["cam_mesh_m"], float(
            np.abs(placed - ref_placed).max()))
    for t, delivered in composites.items():
        drawn = ref_model.composite(ref, t, outputs[t], frames[t])
        off = np.abs(delivered.astype(np.int16) - drawn.astype(np.int16)) > LEVELS
        numbers["composite_off"] = numbers.get("composite_off", 0.0) + float(off.sum())
    return ref


def flops_per_frame(fields: Dict) -> int:
    """``FlopCounterMode`` over the reference network on the meta device
    (convolutions, matrix products, counting a multiply-add as two), one
    frame at the configuration's ``input_size``."""
    return _network_flops(fields["input_size"])


@functools.lru_cache(maxsize=None)
def _network_flops(input_size: int) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    P = network.Params()
    image = torch.empty((1, input_size, input_size, 3), dtype=torch.uint8,
                        device="meta")
    with FlopCounterMode(display=False) as counter:
        network.forward(P, image)
    return int(counter.get_total_flops())


def as_outputs(ref_out: Dict[str, np.ndarray], t: int, fields: Dict) -> Dict:
    """Frame ``t`` of ``Reference.sequence``'s outputs as the program's
    host outputs of that frame: what a reference put in the program's
    place hands the judge."""
    w = fields["centermap_size"]
    return {"verts": ref_out["verts"][t], "j3d": ref_out["j3d"][t],
            "pj2d_org": ref_out["pj2d_org"][t],
            "cam_trans": ref_out["cam_trans"][t],
            "centers": np.stack(
                [ref_out["flat"][t] % w, ref_out["flat"][t] // w], -1),
            "centers_conf": ref_out["score"][t], "params": ref_out["params"][t],
            "detection_flag": ref_out["detected"][t]}
