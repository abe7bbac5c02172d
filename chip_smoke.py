#!/usr/bin/env python3
"""Smoke run of the PyTorch port (acr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the rasterizer kernels from
``acr_tpu_torch/csrc/raster.cu``, holds each kernel against its plain
PyTorch version on the card, drives the image-mode main path
(``ACRApp.process_frame``: full-width HRNet-W32 + ACR heads, parser,
MANO, projection, on-device render, composite) at 512 px on frames made
from a seed, checks the outputs against the port's own CPU run, and
times the device step and the kernels with CUDA events. Any failure
raises and exits nonzero. The last line of standard output is one JSON
object ``{"ok": true, "device": {...}}``; the line before it is the
card's ``nvidia-smi`` name and power limit, and before that a JSON line
with one entry per kernel.

Weights are random (``init_params`` from seed 0), with the two 1x1
fuse convs that emit each hand's parameters damped and biased (see
``_weights``) so that both hands are plausible, near MANO's mean pose,
with the weak-perspective camera (scale, -+0.3, 0). The main path runs
two such weight sets: "near" hands (scale 5) cover a few hundred
pixels, so every tile fits a binned capacity tier (max 363 faces per
tile on the H100 run); "far" hands (scale 0.6) cover a few dozen, so
tiles overflow (max 885) and the frame takes the exact flat kernel.
Both kernels of the path must launch in that run.
"""

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SIZE = 512
N_FRAMES = 3                  # per weight set
# weak-perspective camera scale of both hands in the main path's two runs
CAM_SCALE = {"near": 5.0, "far": 0.6}
# two-hand rest-pose scene for the kernel checks: depth of both hands
SCENE_DEPTH = {"fits": 0.45, "overflows": 2.5}


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, reps=5, warmup=3):
    """ms per call of ``fn`` on the current stream, by CUDA events: the
    mean over ``iters`` calls, in ``reps`` windows. Returns (median of
    the windows, min, max)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        windows.append(start.elapsed_time(end) / iters)
    windows.sort()
    return windows[len(windows) // 2], windows[0], windows[-1]


def ms_text(t):
    return f"{t[0]:.4f} ms (median of 5 windows; min {t[1]:.4f}, max {t[2]:.4f})"


def phase_env():
    import torch
    say("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch CUDA {torch.version.cuda}")
    from acr_tpu_torch.viz.raster_cuda import _nvcc
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    say("env", f"nvcc: {nvcc[-1]}")
    found = {}
    for mod in ("triton", "cv2", "PIL", "yaml", "ninja"):
        try:
            importlib.import_module(mod)
            found[mod] = True
        except ImportError:
            found[mod] = False
    say("env", f"imports: {json.dumps(found)}")
    card = card_line()
    print(card, flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False")
    say("env", f"device 0: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    return card, found


def phase_build():
    from acr_tpu_torch.viz import raster_cuda as rc
    t0 = time.perf_counter()
    so, log = rc.build_extension()
    rc._library()
    dt = time.perf_counter() - t0
    say("build", f"{os.path.relpath(so, ROOT)} in {dt:.2f} s"
        + ("" if log else " (already built from these sources)"))
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            say("build", "ptxas: " + line.strip())
    return dt


def rest_pose_scene(device, depth):
    """Both MANO hands in rest pose, side by side at ``depth`` metres."""
    import torch
    from acr_tpu_torch.models.mano import load_mano_model, mano_forward
    from acr_tpu_torch.config import Config
    mano_dir = Config().mano_model_path
    verts, faces = [], []
    for side in ("left", "right"):
        model, f = load_mano_model(mano_dir, side, device=device)
        v, _, _ = mano_forward(model, torch.zeros(1, 48, device=device),
                               torch.zeros(1, 10, device=device))
        verts.append(v[0])
        faces.append(torch.as_tensor(f, dtype=torch.long, device=device))
    cam_trans = torch.tensor([[-0.09, 0.0, depth], [0.09, 0.0, depth]],
                             device=device)
    det = torch.tensor([True, True], device=device)
    return torch.stack(verts), cam_trans, det, torch.stack(faces)


def phase_kernels():
    """Each kernel against its plain version on the card, binned tiers
    against the flat kernel, and the overflow dispatch."""
    import torch
    from acr_tpu_torch.viz import raster as R
    from acr_tpu_torch.viz import raster_cuda as rc
    dev = torch.device("cuda")
    verts, cam_trans, det, faces = rest_pose_scene(dev, SCENE_DEPTH["fits"])
    screen, all_faces, attrs = R.prepare_scene(verts, cam_trans, det, faces,
                                               SIZE, 1265.0)
    max_faces = int(rc.bin_overflow_stats(screen, all_faces, SIZE, SIZE)[0])
    tri, inv = rc.face_rows(screen, all_faces)
    flat = rc.raster_flat(tri, inv, attrs, SIZE, SIZE)
    plain = rc.raster_flat_plain(tri, inv, attrs, SIZE, SIZE)
    torch.cuda.synchronize()
    if not torch.equal(flat[0], plain[0]):
        raise AssertionError("flat kernel fid differs from the plain version")
    flat_bary_err = max(float((a - b).abs().max())
                        for a, b in zip(flat[1:3], plain[1:3]))
    if flat_bary_err > 1e-5:
        raise AssertionError(f"flat kernel bary err {flat_bary_err}")
    if not torch.equal(flat[3], plain[3]):
        raise AssertionError("flat kernel attrs differ from the plain version")
    covered = int((flat[0] >= 0).sum())
    say("kernels", f"flat vs plain, {all_faces.shape[0]} faces at {SIZE} px: "
        f"fid and attrs equal, bary max err {flat_bary_err:g}, "
        f"{covered} covered pixels (tol: fid/attrs equal, bary 1e-5)")
    if covered < SIZE * SIZE // 20:
        raise AssertionError(f"scene covers only {covered} pixels")

    col_tile = min(rc.COL_TILE, SIZE)
    table = rc.face_table(tri, attrs)
    binned_err, tiers_run = 0.0, []
    for cap in rc.TIERS:
        if max_faces > cap:
            continue
        tri_t, inv_t, ids_t, counts = rc.bin_faces(table, inv, SIZE, SIZE,
                                                   col_tile, cap)
        got = rc.raster_binned(counts, tri_t, inv_t, ids_t, SIZE, SIZE,
                               col_tile)
        for g, f in zip(got, flat):
            if not torch.equal(g, f):
                raise AssertionError(f"binned tier {cap} differs from flat")
        plain_b = rc.raster_binned_plain(counts, tri_t, inv_t, ids_t, SIZE,
                                         SIZE, col_tile)
        if not (torch.equal(got[0], plain_b[0])
                and torch.equal(got[3], plain_b[3])):
            raise AssertionError(f"binned tier {cap} differs from its plain version")
        binned_err = max(binned_err, max(float((a - b).abs().max())
                                         for a, b in zip(got[1:3], plain_b[1:3])))
        tiers_run.append(cap)
    if not tiers_run:
        raise AssertionError(f"scene fits no tier (max {max_faces} faces/tile)")
    say("kernels", f"max {max_faces} faces/tile; binned tiers {tiers_run} "
        f"bit-identical to flat; binned vs plain bary max err {binned_err:g}")

    # a scene above the largest tier: render_hands takes the flat kernel
    o_verts, o_trans, o_det, o_faces = rest_pose_scene(
        dev, SCENE_DEPTH["overflows"])
    o_screen, o_all, _ = R.prepare_scene(o_verts, o_trans, o_det, o_faces,
                                         SIZE, 1265.0)
    o_max = int(rc.bin_overflow_stats(o_screen, o_all, SIZE, SIZE)[0])
    rc.reset_launch_counts()
    rgba = R.render_hands(o_verts, o_trans, o_det, o_faces, size=SIZE)
    launched = dict(rc.LAUNCHES)
    ref = R.render_hands(o_verts.cpu(), o_trans.cpu(), o_det.cpu(),
                         o_faces.cpu(), size=SIZE)
    rgba_err = float((rgba.cpu() - ref).abs().max())
    path = "flat" if launched == {"raster_flat": 1, "raster_binned": 0} else None
    say("kernels", f"overflow scene: max {o_max} faces/tile, render_hands "
        f"took {path or launched}; RGBA vs plain path max err {rgba_err:g} "
        "(tol 1e-5)")
    if o_max <= rc.BIN_CAP or path != "flat" or rgba_err > 1e-5:
        raise AssertionError("overflow dispatch check failed")
    return {"flat_err": flat_bary_err, "binned_err": binned_err}


def _weights(scale):
    """init_params(seed 0), with the 1x1 fuse convs (which emit each
    hand's 109 parameters) and the prior heads' output convs scaled by
    0.05, and the fuse-conv biases set to the camera (scale, -+0.3, 0),
    identity 6D rotations and zero betas: each frame gives two plausible
    hands near MANO's mean pose, left hand left, right hand right."""
    import torch
    from acr_tpu_torch.io.params import init_params
    params = init_params(torch.Generator().manual_seed(0))
    rot6d_identity = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0]).repeat(16)
    for side, tx in (("l", -0.3), ("r", 0.3)):
        params[f"{side}_fuse_conv.weight"] *= 0.05
        params[f"{side}_fuse_conv.weight"][:3] = 0.0
        params[f"{side}_fuse_conv.bias"][:] = torch.cat([
            torch.tensor([scale, tx, 0.0]), rot6d_identity, torch.zeros(10)])
        params[f"{side}_prior_head.out.weight"] *= 0.05
    return params


def phase_main(out_dir):
    """The image-mode main path at full width, 512 px, fp32, b1."""
    import numpy as np
    import torch
    from acr_tpu_torch.config import Config
    from acr_tpu_torch.pipeline.app import ACRApp
    from acr_tpu_torch.viz import raster as R
    from acr_tpu_torch.viz import raster_cuda as rc
    has_cv2 = importlib.util.find_spec("cv2") is not None
    cfg = Config(input_size=SIZE, render_size=SIZE, configs_yml="",
                 centermap_conf_thresh=-1e9, output_dir=out_dir)
    apps = {name: ACRApp(cfg, params=_weights(s), device="cuda")
            for name, s in CAM_SCALE.items()}
    rng = np.random.RandomState(0)
    frames = [(rng.rand(SIZE, SIZE, 3) * 255).astype(np.uint8)
              for _ in range(N_FRAMES)]
    if not has_cv2:
        say("main", "cv2 is not installed: the host composite and the "
            "written frame are skipped; the device step runs alone")
    rc.reset_launch_counts()
    t0 = time.perf_counter()
    outs, paths = [], []
    for name, app in apps.items():
        for i, frame in enumerate(frames):
            before = dict(rc.LAUNCHES)
            if has_cv2:
                app.process_frame(frame, f"{name}_{i}.jpg")
                out = app.last_output
            else:
                from acr_tpu_torch.pipeline.preprocess import img_preprocess
                out = app.device_step(img_preprocess(frame, None, SIZE))
            took = [k for k in rc.LAUNCHES if rc.LAUNCHES[k] > before[k]]
            outs.append((name, i, out))
            paths.append(took)
    wall = time.perf_counter() - t0
    launches = dict(rc.LAUNCHES)
    for (name, i, out), took in zip(outs, paths):
        probe = R.render_overflow_probe(
            torch.as_tensor(out["verts"][0]), torch.as_tensor(out["cam_trans"][0]),
            torch.as_tensor(out["detection_flag"][0]),
            apps[name].visualizer.faces.cpu(), size=SIZE)
        say("main", f"{name} frame {i}: max {int(probe[0])} faces/tile -> "
            f"{took}; cam scale {out['cam'][0, :, 0].round(3).tolist()}")
        if out["verts"].shape != (1, 2, 778, 3) or out["j3d"].shape != (1, 2, 21, 3):
            raise AssertionError("output shapes")
        if out["_rgba"].shape != (4, SIZE, SIZE):
            raise AssertionError(f"RGBA shape {out['_rgba'].shape}")
        for k in ("verts", "j3d", "pj2d", "cam_trans", "_rgba"):
            if not np.isfinite(out[k]).all():
                raise AssertionError(f"non-finite {k}")
        if not out["detection_flag"].all():
            raise AssertionError("both hands must be detected")
        if not out["_rgba"][3].any():
            raise AssertionError("the render drew nothing")
    written = len(os.listdir(out_dir)) if has_cv2 else 0
    say("main", f"{2 * N_FRAMES} frames through ACRApp.process_frame in "
        f"{wall:.2f} s (first frames include cuDNN set-up); launches "
        f"{launches}; {written} composited frames written")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: {missing}")
    return launches, apps, frames


def phase_device_vs_cpu(apps, frames):
    """The port on the card against the port on the CPU, same weights."""
    import torch
    from acr_tpu_torch.pipeline.infer import ACRPipeline
    from acr_tpu_torch.pipeline.preprocess import img_preprocess
    app = apps["near"]
    meta = img_preprocess(frames[0], None, SIZE)
    gpu = {k: v.cpu() for k, v in app.pipeline(meta["image"],
                                                meta["offsets"]).items()}
    cpu_pipe = ACRPipeline(app.cfg, params=_weights(CAM_SCALE["near"]),
                           device="cpu")
    cpu = cpu_pipe(meta["image"], meta["offsets"])
    if not torch.equal(gpu["centers"], cpu["centers"]):
        raise AssertionError("device and CPU picked different centers")
    errs = {}
    for k, tol in (("verts", 1e-4), ("j3d", 1e-4), ("pj2d", 1e-4)):
        errs[k] = float((gpu[k] - cpu[k]).abs().max())
        if errs[k] > tol:
            raise AssertionError(f"{k}: device vs CPU err {errs[k]} > {tol}")
    say("device_vs_cpu", f"max abs err {json.dumps(errs)} "
        "(tol 1e-4, TF32 off on cuDNN and cuBLAS)")


def _main_path_scene(app):
    """The app's last main-path frame as render_hands builds it, on the card."""
    import torch
    from acr_tpu_torch.viz import raster as R
    out = app.last_output
    t = lambda k: torch.as_tensor(out[k][0]).cuda()
    return R.prepare_scene(t("verts"), t("cam_trans"), t("detection_flag"),
                           app.visualizer.faces, SIZE, app.cfg.focal_length)


def _max_err(got, want):
    """fid and attribute planes must be equal; returns the bary max err."""
    import torch
    if not (torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])):
        raise AssertionError("kernel and plain version disagree on fid/attrs")
    err = max(float((a - b).abs().max()) for a, b in zip(got[1:3], want[1:3]))
    if err > 1e-5:
        raise AssertionError(f"kernel and plain version bary err {err}")
    return err


def phase_times(card, apps, frames):
    """Device step and kernels on the main path's own frames, CUDA events."""
    import torch
    from acr_tpu_torch.pipeline.preprocess import img_preprocess
    from acr_tpu_torch.viz import raster as R
    from acr_tpu_torch.viz import raster_cuda as rc
    times, errs = {}, {}
    for name, app in apps.items():
        meta = img_preprocess(frames[0], None, SIZE)
        image = torch.as_tensor(meta["image"]).cuda()
        offsets = torch.as_tensor(meta["offsets"]).cuda()

        def step():
            with torch.no_grad():
                out = app.pipeline(image, offsets)
                app.visualizer.render_rgba_device(out)
        times[f"step_{name}"] = cuda_ms(step, iters=20)
        say("times", f"b1 fp32 {SIZE} px device step (forward + render), "
            f"{name} hands: {ms_text(times[f'step_{name}'])} [{card}]")
        # host clock around ACRApp.device_step: upload, step, one readback
        walls = []
        for i in range(23):
            t0 = time.perf_counter()
            app.device_step(meta)
            if i >= 3:
                walls.append((time.perf_counter() - t0) * 1e3)
        walls.sort()
        say("times", f"ACRApp.device_step host wall (incl. readback), {name} "
            f"hands: median {walls[10]:.3f} ms, min {walls[0]:.3f}, max "
            f"{walls[-1]:.3f} over 20 calls [{card}]")

    # flat kernel on the "far" frame, which overflows every tier
    screen, faces, attrs = _main_path_scene(apps["far"])
    if R.select_tier(screen, faces, SIZE) is not None:
        raise AssertionError("the far frame should take the flat kernel")
    tri, inv = rc.face_rows(screen, faces)
    errs["raster_flat"] = _max_err(rc.raster_flat(tri, inv, attrs, SIZE, SIZE),
                                   rc.raster_flat_plain(tri, inv, attrs, SIZE, SIZE))
    # binned kernel on the "near" frame, at the tier render_hands picks
    screen, faces, attrs = _main_path_scene(apps["near"])
    cap = R.select_tier(screen, faces, SIZE)
    if cap is None:
        raise AssertionError("the near frame should take a binned tier")
    b_tri, b_inv = rc.face_rows(screen, faces)
    col_tile = min(rc.COL_TILE, SIZE)
    tri_t, inv_t, ids_t, counts = rc.bin_faces(rc.face_table(b_tri, attrs),
                                               b_inv, SIZE, SIZE, col_tile, cap)
    binned_args = (counts, tri_t, inv_t, ids_t, SIZE, SIZE, col_tile)
    errs["raster_binned"] = _max_err(rc.raster_binned(*binned_args),
                                     rc.raster_binned_plain(*binned_args))
    kernels = {
        "raster_flat": lambda: rc.raster_flat(tri, inv, attrs, SIZE, SIZE),
        "raster_flat_plain": lambda: rc.raster_flat_plain(tri, inv, attrs,
                                                          SIZE, SIZE),
        "raster_binned": lambda: rc.raster_binned(*binned_args),
        "raster_binned_plain": lambda: rc.raster_binned_plain(*binned_args),
    }
    for name, fn in kernels.items():
        times[name] = cuda_ms(fn, iters=10 if "plain" in name else 50)
        scene = (f"near frame, tier {cap}" if "binned" in name
                 else "far frame")
        say("times", f"{name} ({SIZE} px, {inv.shape[0]} faces, {scene}): "
            f"{ms_text(times[name])} [{card}]")
    return {k: v[0] for k, v in times.items()}, errs


def main():
    if not os.path.isdir(os.path.join(ROOT, "acr_tpu_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         "repository (acr_tpu_torch/ not found beside it)")
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: torch.cuda.is_available() is False")
    card, _ = phase_env()
    phase_build()
    kin = phase_kernels()
    out_dir = os.path.join(ROOT, "build", "chip_smoke_out")
    launches, apps, frames = phase_main(out_dir)
    phase_device_vs_cpu(apps, frames)
    times, errs = phase_times(card, apps, frames)
    src = "acr_tpu_torch/csrc/raster.cu"
    print(json.dumps({"kernels": [
        {"name": "raster_flat", "route": "cuda", "source": src,
         "replaces": "acr_tpu/viz/raster_pallas.py:106",
         "launches": launches["raster_flat"],
         "max_abs_err": max(kin["flat_err"], errs["raster_flat"]),
         "ms": times["raster_flat"], "plain_ms": times["raster_flat_plain"]},
        {"name": "raster_binned", "route": "cuda", "source": src,
         "replaces": "acr_tpu/viz/raster_pallas.py:193",
         "launches": launches["raster_binned"],
         "max_abs_err": max(kin["binned_err"], errs["raster_binned"]),
         "ms": times["raster_binned"],
         "plain_ms": times["raster_binned_plain"]},
    ]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
