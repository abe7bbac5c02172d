"""``correct``: the program's outputs held against the frozen reference.

The reference recomputes every frame the program processed, in the
program's order, from the same frames and weights: the network in fp32
with TF32 off (in blocks of frames), the centres, the sampled
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
more than 8 levels from the reference's render and composite of the
program's own geometry. The render stage is judged on the program's
geometry (which the other numbers judge on their own), so that the
reference's float32 edge tests meet the same vertices as the program's
kernel; what remains are edge pixels and the shading round-off (MANO's
vertex 767 has faces whose normals nearly cancel).

Which numbers a cell compares, and their limits, is the configuration
file's ``limits``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from port_bench.reference import camera, host, mano, network, parse, render, temporal

LEVELS = 8
BLOCK = 16


@contextlib.contextmanager
def fp32_math(tf32: bool = False):
    """fp32 products and convolutions, TF32 on only for a control."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


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
                   numbers: Dict[str, float], map_width: int) -> Dict:
    """Add one sequence's readings to ``numbers`` (widest wins):
    ``outputs[t]`` the program's host outputs of frame ``t`` (one image,
    hand axis first), ``judged`` the frames to compare, ``composites``
    delivered frames to compare by index. Returns the reference's
    outputs."""
    ref = ref_model.sequence(frames, picks_of(outputs, map_width))
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


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            judged: int):
    """(correct, [[name, number, limit], ...]) over the numbers that the
    configuration gives a limit; a run that finished no frame to judge
    is not correct."""
    checks = [[k, numbers[k], float(limits[k])] for k in numbers if k in limits]
    return judged > 0 and all(v <= lim for _, v, lim in checks), checks
