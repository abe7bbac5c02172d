"""Quantify the int8 (W8A8) serving path's END-TO-END accuracy, on the port.

Counterpart of ``tools/quant_accuracy.py``. The int8 path
(``ops/quant.py``, ``Config.quantize='int8'|'int8_pc'|'int8_r'|'int4w'``)
is an approximation; this tool measures what that approximation costs in
OUTPUT space — the space users consume — rather than on intermediate
maps:

* mean / max per-vertex displacement of the 778-vertex mesh, absolute
  (MANO model units, metres) and relative to the hand's bbox diagonal;
* mean 3D joint displacement (21 joints);
* mean / max projected-2D joint error in input pixels;
* detection-flag flips at the 0.35 center-confidence threshold
  (reference: acr/config.py:131) and the worst confidence delta;
* camera / translation drift.

Evaluated for each quant mode under two calibration recipes:
(a) DEFAULT — whatever load-time calibration resolves to (the committed
real-frame set model_data/calib at its input size, else the synthetic
noise+mid-gray pair); (b) FRAMES — the evaluation frames themselves
(the deployment-specific recipe: ``ACRPipeline.calibrate(frames)``).

Frames: deterministic synthetic frames, after the photo that
``--image`` names (a real two-hand photo such as the reference's
``demo/magic.jpg``) where one is given. Weights: ``--model_path``
(``checkpoints/wild.npz`` by default, e.g. from
``tools.make_synthetic_checkpoint`` or ``tools.convert_checkpoint``);
``--reference_init DIR`` instead converts a freshly-initialized reference
torch model's state_dict (realistic per-layer weight statistics) from
the reference implementation's checkout at DIR.

Runs on ``--device`` (``cuda`` by default; it raises without a card
unless ``--device cpu`` is given). Prints a markdown table and writes
JSON with ``--json_out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from acr_tpu_torch.config import _REPO_ROOT

COLS = ["vert_rel_mean_pct", "vert_rel_max_pct", "j3d_disp_mean",
        "pj2d_err_mean_px", "pj2d_err_max_px", "detection_flips",
        "center_conf_delta_max"]


def build_frames(input_size: int, n_synth: int = 2,
                 image: Optional[str] = None) -> List[Tuple[str, Dict]]:
    """(name, preprocessed meta) eval set: the photo at ``image`` (when
    given) + synthetic."""
    from acr_tpu_torch.pipeline.preprocess import img_preprocess
    frames = []
    if image is not None:
        import cv2
        bgr = cv2.imread(image)
        if bgr is None:
            raise FileNotFoundError(f"photo missing or unreadable: {image}")
        frames.append((os.path.basename(image),
                       img_preprocess(bgr, image, input_size=input_size)))
    rng = np.random.RandomState(7)
    for i in range(n_synth):
        bgr = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
        frames.append((f"synthetic_{i}",
                       img_preprocess(bgr, f"synthetic_{i}",
                                      input_size=input_size)))
    return frames


def _forward_all(pipe, frames):
    from acr_tpu_torch.pipeline.app import readback
    return [readback(pipe(meta["image"], meta["offsets"]))
            for _, meta in frames]


def compare_outputs(ref_outs: List[Dict], q_outs: List[Dict],
                    input_size: int) -> Dict[str, float]:
    """Aggregate error metrics across frames/hands (float pipeline =
    ground truth)."""
    v_disp, v_rel, j_disp, p_err, t_err = [], [], [], [], []
    flips = 0
    conf_delta = 0.0
    for ref, q in zip(ref_outs, q_outs):
        fv = np.asarray(ref["verts"], np.float64)     # (B,2,778,3)
        qv = np.asarray(q["verts"], np.float64)
        dv = np.linalg.norm(qv - fv, axis=-1)          # (B,2,778)
        diag = np.linalg.norm(fv.max(-2) - fv.min(-2), axis=-1)  # (B,2)
        v_disp.append(dv)
        v_rel.append(dv / np.maximum(diag[..., None], 1e-9))
        j_disp.append(np.linalg.norm(
            np.asarray(q["j3d"], np.float64)
            - np.asarray(ref["j3d"], np.float64), axis=-1))
        # pj2d is in [-1, 1]; scale to input pixels
        p_err.append(np.linalg.norm(
            np.asarray(q["pj2d"], np.float64)
            - np.asarray(ref["pj2d"], np.float64), axis=-1)
            * (input_size / 2.0))
        t_err.append(np.linalg.norm(
            np.asarray(q["cam_trans"], np.float64)
            - np.asarray(ref["cam_trans"], np.float64), axis=-1))
        flips += int((np.asarray(q["detection_flag"])
                      != np.asarray(ref["detection_flag"])).sum())
        conf_delta = max(conf_delta, float(np.abs(
            np.asarray(q["centers_conf"], np.float64)
            - np.asarray(ref["centers_conf"], np.float64)).max()))
    v_disp = np.concatenate([a.ravel() for a in v_disp])
    v_rel = np.concatenate([a.ravel() for a in v_rel])
    j_disp = np.concatenate([a.ravel() for a in j_disp])
    p_err = np.concatenate([a.ravel() for a in p_err])
    t_err = np.concatenate([a.ravel() for a in t_err])
    return {
        "vert_disp_mean": float(v_disp.mean()),
        "vert_disp_max": float(v_disp.max()),
        "vert_rel_mean_pct": float(v_rel.mean() * 100.0),
        "vert_rel_max_pct": float(v_rel.max() * 100.0),
        "j3d_disp_mean": float(j_disp.mean()),
        "pj2d_err_mean_px": float(p_err.mean()),
        "pj2d_err_max_px": float(p_err.max()),
        "cam_trans_err_mean": float(t_err.mean()),
        "detection_flips": flips,
        "center_conf_delta_max": float(conf_delta),
    }


def run_eval(params=None, input_size: int = 512,
             modes: Tuple[str, ...] = ("int8", "int8_pc"),
             mano_dir: Optional[str] = None, n_synth: int = 2,
             model_path: Optional[str] = None, device="cuda",
             image: Optional[str] = None) -> Dict[str, Dict]:
    """Float-vs-quantized comparison for each (mode, calibration).

    ``params`` is a float state dict of the canonical ACRNet, or None to
    load ``model_path`` (default ``checkpoints/wild.npz``); ``image`` adds
    a photo to the synthetic frames. Returns {"<mode>/<calib>": metrics}.
    """
    from acr_tpu_torch.config import Config
    from acr_tpu_torch.io.params import load_params
    from acr_tpu_torch.pipeline.infer import ACRPipeline

    mano_dir = mano_dir or os.path.join(_REPO_ROOT, "model_data", "mano")
    model_path = model_path or os.path.join(_REPO_ROOT, "checkpoints",
                                            "wild.npz")
    merge = None
    if params is None:
        params, merge = load_params(model_path)
    base = dict(input_size=input_size, mano_model_path=mano_dir,
                model_path=model_path)
    frames = build_frames(input_size, n_synth=n_synth, image=image)

    float_pipe = ACRPipeline(Config(**base), params=params, device=device,
                             merge_params=merge)
    ref_outs = _forward_all(float_pipe, frames)
    del float_pipe

    results: Dict[str, Dict] = {}
    for mode in modes:
        qpipe = ACRPipeline(Config(quantize=mode, **base), params=params,
                            device=device, merge_params=merge)
        results[f"{mode}/default"] = compare_outputs(
            ref_outs, _forward_all(qpipe, frames), input_size)
        # production recipe: calibrate on the frames being served
        qpipe.calibrate([meta["image"] for _, meta in frames])
        results[f"{mode}/frames"] = compare_outputs(
            ref_outs, _forward_all(qpipe, frames), input_size)
    return results


def reference_init_params(reference_dir: str):
    """Convert a freshly-initialized reference torch model's state_dict
    -> the port's state dict (realistic per-layer weight statistics),
    with the centre heads biased (``bias_detection``). ``reference_dir``
    is the reference implementation's checkout; raises naming it where
    its ``acr/`` is missing."""
    if not os.path.isdir(os.path.join(reference_dir, "acr")):
        raise FileNotFoundError(
            f"--reference_init needs the reference implementation's "
            f"checkout (its acr/model.py) at {reference_dir}; it is missing")
    import types
    for name in ("imgaug", "imgaug.augmenters", "h5py", "chumpy"):
        if name not in sys.modules:
            try:
                __import__(name)
            except ImportError:
                sys.modules[name] = types.ModuleType(name)
    aug = sys.modules["imgaug.augmenters"]
    for attr in ("Sequential", "Crop", "Pad"):
        if not hasattr(aug, attr):
            setattr(aug, attr, lambda *a, **k: None)
    if not hasattr(aug, "compute_paddings_to_reach_aspect_ratio"):
        aug.compute_paddings_to_reach_aspect_ratio = \
            lambda *a, **k: (0, 0, 0, 0)
    argv_backup, sys.argv = sys.argv, ["prog"]
    if reference_dir not in sys.path:
        sys.path.insert(0, reference_dir)
    try:
        import torch
        torch.manual_seed(0)
        from acr.model import ACR as RefACR
        model = RefACR().eval()
    finally:
        sys.argv = argv_backup
    from acr_tpu_torch.io.params import from_flax
    from acr_tpu_torch.tools.convert_checkpoint import (
        convert_state_dict, enumerate_flax_paths)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    flat, _, missing = convert_state_dict(sd, enumerate_flax_paths())
    if missing:
        raise KeyError(f"reference model does not cover the network: "
                       f"{missing[:8]}")
    return bias_detection(from_flax(flat))


def bias_detection(params, bias: float = 0.5):
    """Shift the center-head output bias so random-init weights still
    produce detections (the detection-flip metric needs confidences
    that clear the 0.35 threshold); conv weight statistics untouched.
    Returns a new state dict."""
    out = dict(params)
    for side in "lr":
        key = f"{side}_center_head.out.bias"
        out[key] = params[key] + bias
    return out


def format_table(results: Dict[str, Dict]) -> str:
    lines = ["| config | " + " | ".join(COLS) + " |",
             "|" + "---|" * (len(COLS) + 1)]
    for name, m in results.items():
        row = [name] + [f"{m[c]:.4g}" if isinstance(m[c], float)
                        else str(m[c]) for c in COLS]
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--input_size", type=int, default=512)
    ap.add_argument("--modes", nargs="+", default=["int8", "int8_pc"])
    ap.add_argument("--reference_init", metavar="REFERENCE_DIR",
                    help="use converted reference-init weights, from the "
                         "reference implementation's checkout at "
                         "REFERENCE_DIR, instead of --model_path")
    ap.add_argument("--model_path", default=os.path.join(
        _REPO_ROOT, "checkpoints", "wild.npz"))
    ap.add_argument("--image", default=None,
                    help="a photo to evaluate beside the synthetic frames")
    ap.add_argument("--n_synth", type=int, default=2)
    ap.add_argument("--json_out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless 'cpu')")
    args = ap.parse_args(argv)

    from acr_tpu_torch.utils.device import resolve_device
    resolve_device(args.device)
    params = (reference_init_params(args.reference_init)
              if args.reference_init else None)
    results = run_eval(params, input_size=args.input_size,
                       modes=tuple(args.modes), n_synth=args.n_synth,
                       model_path=args.model_path, device=args.device,
                       image=args.image)
    print(format_table(results))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.json_out}")
    return results


if __name__ == "__main__":
    main()
