#!/usr/bin/env python3
"""Smoke run of the PyTorch port (acr_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``acr_tpu_torch/csrc/raster.cu`` and ``csrc/mano.cu``, holds each kernel
against its plain PyTorch version on the card, and drives three paths on
frames made from a seed:
- the image-mode path (``ACRApp.process_frame``: full-width HRNet-W32 +
  ACR heads, parser, MANO, projection, on-device render, composite) at
  512 px, through the binned kernel, which draws overflowing tiles
  exactly without a host read;
- the webcam stream path (``StreamingLoop`` over 720p frames:
  the same forward, OneEuro smoothing (``-t``), MANO refine, render)
  at ``render_size`` 2048, through the banded kernel, and again at 512;
- the throughput path (``ACRApp.run_folder`` over 720p JPEG frames at
  ``val_batch_size`` 8 with ``-t``: the chunk step's forward, OneEuro
  over the chunk, MANO refine, a render per frame), through the fused
  MANO kernel (``use_pallas_mano="on"``) and the binned kernel;
- the precision paths at full width and 512 px: ``int8_conv2d`` (im2col
  and ``torch._int_mm``) bit for bit against its plain version at all 338
  quantized convs, timed beside the bf16 cuDNN conv of each shape; the
  bf16 image path against the port's bf16 on the CPU and the card's fp32;
  the W8A8 modes calibrated at load on the committed frames, held to the
  int8 output-space budget; folder mode at fp32 b8, bf16 b8 and
  bf16+int8 b16; and one image-mode frame with every auxiliary view;
- data parallelism: folder mode at ``val_batch_size`` 16 on two
  replicas of the card (``devices=["cuda:0", "cuda:0"]``), with and
  without ``-t``, and two processes of one replica each joined over gloo
  (``python3 chip_smoke.py --dp-worker ...`` is one of them), each chunk
  against the 1-replica chunk step;
- the native host paths (``renderer='native'``, the host translation
  solve) in image and folder mode against the port on the CPU, and the
  CLI in image mode with ``--profile_dir`` and its config session.
It checks them against the port's own CPU run, and times the steps, the
loop, the chunk step, folder mode and the kernels: each kernel by CUDA
events around back-to-back calls (``ms``) and alone on the device, as
launches captured in one CUDA graph and replayed (``device_ms``). Any
failure raises and exits nonzero. The last line of standard output is
one JSON object ``{"ok": true, "device": {...}}``; the line before it is
the card's ``nvidia-smi`` name and power limit, and before that a JSON
line with one entry per kernel.

Weights are random (``init_params`` from seed 0), with the two 1x1
fuse convs that emit each hand's parameters damped and biased (see
``_weights``) so that both hands are plausible, near MANO's mean pose,
with the weak-perspective camera (scale, -+0.3, 0). The main path runs
two such weight sets: "near" hands (scale 5) cover a few hundred
pixels, so every tile fits the binned capacity (max 363 faces per tile
on the H100 run); "far" hands (scale 0.6) cover a few dozen, so tiles
overflow (max 885) and the binned kernel draws their other faces from
the full face table. The binned kernel must launch in that run, and the
512 px render must make no host sync (``torch.cuda.set_sync_debug_mode``).
The flat kernel runs where a 2048 px band overflows: one image-mode frame
at render 2048 of the "far" hands moved into one 256-row band (its
launch is counted in that run, from 0). The stream runs the
"near" weights: at 2048 px the hands straddle two 256-row bands, so
every band and tile fits the banded kernel's caps.
"""

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SIZE = 512
HI = 2048                     # the stream path's render size
N_FRAMES = 3                  # per weight set
N_STREAM = 4                  # frames of each stream run
N_LOOP = 12                   # frames of each timed loop (2 warm-up)
FRAME_HW = (720, 1280)        # a 720p webcam frame
# weak-perspective camera scale of both hands in the main path's two runs
CAM_SCALE = {"near": 5.0, "far": 0.6}
# the band-overflow frame's camera ty: the 2048 px render keeps the input's
# focal length, so the "far" hands (about 20 px tall) sit 128 px below the
# canvas's centre, both inside one 256-row band instead of across two
BAND_TY = 0.5
# two-hand rest-pose scene for the kernel checks: depth of both hands
SCENE_DEPTH = {"fits": 0.45, "overflows": 2.5, "fits_hi": 0.2}


T0 = time.perf_counter()


def say(phase, msg):
    print(f"[{phase} +{time.perf_counter() - T0:.1f}s] {msg}", flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, reps=5, warmup=3):
    """ms per call of ``fn`` on the current stream, by CUDA events: the
    mean over ``iters`` calls, in ``reps`` windows. Returns (median of
    the windows, min, max, number of windows, the sorted windows)."""
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
    return windows[len(windows) // 2], windows[0], windows[-1], reps, windows


def graph_ms(fn, n=50, reps=5):
    """Device ms per call of ``fn``: ``n`` calls captured in one CUDA
    graph and replayed, timed by CUDA events, so the host's issue time
    drops out. Returns the median of ``reps`` replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    windows = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        windows.append(start.elapsed_time(end) / n)
    del graph
    return sorted(windows)[reps // 2]


def host_issue_ms(fn, n=200):
    """Host ms per call of ``fn`` issued back to back (the host clock
    from the first call's issue to the last one's return; no sync in
    between), after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e3


def ms_text(t):
    return (f"{t[0]:.4f} ms (median of {t[3]} windows; min {t[1]:.4f}, "
            f"max {t[2]:.4f})")


# the card's peak rates for bound_ms (H100 SXM data sheet: HBM3 bytes/s;
# fp32 operations/s outside the tensor cores, which counts an FFMA as two
# operations: 132 SMs x 128 lanes x 1.98 GHz x 2)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# the rasterizers' edge math is compiled with --fmad=false: only FADD and
# FMUL, one operation per lane per clock, half the rate above
PEAK_FADD_FMUL_S = 33.5e12
# fp32 operations of the rasterizers' edge math per (face, pixel) pair:
# w0 and w1 8 each, w2 2, depth 5 (csrc/raster.cu edge_test)
EDGE_FLOPS = 23
# bytes written per pixel by every rasterizer: fid, b0, b1, 16 attr planes
PIXEL_OUT_BYTES = 19 * 4


def bound(n_bytes, n_flops, flops_s=PEAK_FADD_FMUL_S):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the fp32 operations over ``flops_s`` (the FADD
    and FMUL rate of the rasterizers by default). Returns (ms, "bytes" or
    "operations")."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_flops / flops_s
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def flat_bound(n_faces, pairs, height, width):
    """B2 on these inputs: 26 rows per face (triangle, inverse area,
    attributes) read once and the pixels written once; the edge math of
    the live (face, block) pairs that its cull keeps over the block's
    8 x 128 pixels."""
    return bound(4 * 26 * n_faces + PIXEL_OUT_BYTES * height * width,
                 EDGE_FLOPS * pairs * 8 * 128)


def binned_bound(tri, inv, counts, ids_t, height, width, col_tile):
    """B1 on these inputs: for each face that reaches a tile (the
    unclipped counts: a kept slot's 34 rows of tri_t, inv_t and ids_t, or
    an overflow face's 26 rows of the table; 34 counted for each), read
    once, the counts read and the pixels written once; the edge math of
    the (face, 8 x 128 block) pairs the kernel folds over the block's
    pixels: a tile's candidates (its kept slots and, above the cap, every
    face after the last kept id) that its cull (flat_cull_mask) keeps in
    each block of the tile. Returns (the bound, the (face, tile) pairs,
    the (face, block) pairs)."""
    import torch
    from acr_tpu_torch.viz import raster_cuda as rc
    dev = ids_t.device
    n_tiles, cap = ids_t.shape
    n_faces = tri.shape[1]
    cand = torch.zeros((n_tiles, n_faces + 1), dtype=torch.bool, device=dev)
    cand.scatter_(1, torch.where(ids_t >= 0, ids_t, n_faces).long(), True)
    after = torch.arange(n_faces, device=dev)[None] > ids_t[:, cap - 1:]
    cand = cand[:, :n_faces] | ((counts > cap)[:, None] & after)
    cull = rc.flat_cull_mask(tri, inv, height, width)
    block = torch.arange(cull.shape[0], device=dev)
    n_bx = -(-width // rc.FLAT_TILE_W)
    tile = ((block // n_bx) * (width // col_tile)
            + (block % n_bx) * rc.FLAT_TILE_W // col_tile)
    live, pairs = int(counts.sum()), int((cand[tile] & cull).sum())
    return bound(4 * (34 * live + counts.numel())
                 + PIXEL_OUT_BYTES * height * width,
                 EDGE_FLOPS * pairs * rc.FLAT_TILE_H * rc.FLAT_TILE_W), \
        live, pairs


def mano_bound(batch):
    """B4 at ``batch`` hands: coef, g_rows, basis and weights read once,
    the vertices written once; the two products and the affine, whose
    products are FMAs (the 67e12 rate)."""
    n_bytes = 4 * (batch * 146 + batch * 192 + 146 * 3 * 778 + 16 * 778
                   + batch * 778 * 3)
    n_flops = batch * 778 * (2 * (146 * 3 + 12 * 16) + 18)
    return bound(n_bytes, n_flops, PEAK_FP32_S)


def phase_env():
    import torch
    say("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch CUDA {torch.version.cuda}")
    from acr_tpu_torch.ops.cuda_lib import nvcc as _nvcc
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    say("env", f"nvcc: {nvcc[-1]}")
    # the host compiler: nvcc's, and the native library's (io/native.py)
    from acr_tpu_torch.io.native import CXX
    gxx = subprocess.run([CXX, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    say("env", f"{CXX}: {gxx[0]}")
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
    from acr_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    so, log = cuda_lib.build_extension()
    cuda_lib.library()
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
    """The flat and binned kernels against their plain versions on the
    card, the binned kernel against the flat one at three caps, and an
    overflowing frame through render_hands."""
    import torch
    from acr_tpu_torch.viz import raster as R
    from acr_tpu_torch.viz import raster_cuda as rc
    dev = torch.device("cuda")
    verts, cam_trans, det, faces = rest_pose_scene(dev, SCENE_DEPTH["fits"])
    screen, all_faces, attrs = R.prepare_scene(verts, cam_trans, det, faces,
                                               SIZE, 1265.0)
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

    # the kernel's own cull on a NaN vertex (the fan of faces around it
    # has NaN bboxes), at a ragged size: rows not a multiple of 8 and
    # columns not of 128, the edge through the hands
    fids = flat[0][flat[0] >= 0].long()
    top = int(torch.bincount(fids).argmax())     # the face that draws most
    nan_screen = screen.clone()
    nan_screen[all_faces[top, 0]] = float("nan")
    n_tri, n_inv = rc.face_rows(nan_screen, all_faces)
    nan_faces = torch.isnan(n_tri[:6]).any(dim=0)
    rh, rw = SIZE - 12, SIZE - 230
    got = rc.raster_flat(n_tri, n_inv, attrs, rh, rw)
    want = rc.raster_flat_plain(n_tri, n_inv, attrs, rh, rw)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("flat kernel differs from the plain version on "
                             "the NaN-vertex scene")
    n_drawn = int((got[0] >= 0).sum())
    edge = int((got[0][:, -1] >= 0).sum())
    if nan_faces[got[0][got[0] >= 0].long()].any() or not edge:
        raise AssertionError("NaN-vertex scene: a NaN face won a pixel, or "
                             "the ragged edge cuts no drawn face")
    say("kernels", f"flat vs plain with a NaN vertex ({int(nan_faces.sum())} "
        f"NaN faces, one of them the frame's largest) at {rh}x{rw} px: fid, "
        f"bary and attrs equal bit for bit; {n_drawn} covered pixels, {edge} "
        "on the last column; no NaN face drawn")

    # B1 with exact overflow against its plain version and against B2, bit
    # for bit, at caps 128, 256 and 512: on this scene, on the NaN-vertex
    # scene at 512 px, and on a scene above the cap of 512
    o_scene = rest_pose_scene(dev, SCENE_DEPTH["overflows"])
    o_screen, o_all, o_attrs = R.prepare_scene(*o_scene, SIZE, 1265.0)
    scenes = {"rest pose": (screen, all_faces, attrs),
              "NaN vertex": (nan_screen, all_faces, attrs),
              "overflow": (o_screen, o_all, o_attrs)}
    for name, (s_screen, s_faces, s_attrs) in scenes.items():
        s_tri, s_inv = rc.face_rows(s_screen, s_faces)
        s_flat = rc.raster_flat(s_tri, s_inv, s_attrs, SIZE, SIZE)
        for cap in (128, 256, rc.BIN_CAP):
            args, table = binned_inputs(s_tri, s_inv, s_attrs, SIZE, cap)
            got = rc.raster_binned(*args, table=table)
            plain_b = rc.raster_binned_plain(*args, table=table)
            torch.cuda.synchronize()
            if not all(torch.equal(g, p) and torch.equal(g, f)
                       for g, p, f in zip(got, plain_b, s_flat)):
                raise AssertionError(f"binned kernel at cap {cap} on the "
                                     f"{name} scene differs from its plain "
                                     "version or from flat")
        mx, n_over = (int(x) for x in rc.bin_overflow_stats(
            s_screen, s_faces, SIZE, SIZE))
        say("kernels", f"binned vs plain and flat, {name} scene at {SIZE} "
            f"px (max {mx} faces/tile, {n_over} tiles above 512), caps 128, "
            "256, 512, overflow drawn from the face table: fid, bary and "
            "attrs equal bit for bit")
    if n_over < 1:
        raise AssertionError("the overflow scene has no tile above 512")

    # the overflow scene through render_hands: one binned launch, no host
    # sync, the plain path's RGBA on the CPU
    R.render_hands(*o_scene, size=SIZE)                   # warm-up
    rc.reset_launch_counts()
    rgba = sync_free(lambda: R.render_hands(*o_scene, size=SIZE))
    launched = {k: v for k, v in rc.LAUNCHES.items() if v}
    ref = R.render_hands(*(x.cpu() for x in o_scene), size=SIZE)
    rgba_err = float((rgba.cpu() - ref).abs().max())
    say("kernels", f"overflow scene through render_hands under "
        f"set_sync_debug_mode('error'): launches {launched}; RGBA vs the "
        f"plain path on the CPU max err {rgba_err:g} (tol 1e-5)")
    if launched != {"raster_binned": 1} or rgba_err > 1e-5:
        raise AssertionError("overflow render check failed")
    return {"flat_err": flat_bary_err, "binned_err": 0.0}


def binned_inputs(tri, inv, attrs, size, cap):
    """The render path's B1 operands for one frame: (the positional
    arguments of raster_binned; the face table)."""
    from acr_tpu_torch.viz import raster_cuda as rc
    col_tile = min(rc.COL_TILE, size)
    table = rc.face_table(tri, attrs, inv)
    tri_t, inv_t, ids_t, counts = rc.bin_faces(table, inv, size, size,
                                               col_tile, cap)
    return (counts, tri_t, inv_t, ids_t, size, size, col_tile), table


def sync_free(fn):
    """``fn()`` under torch.cuda.set_sync_debug_mode("error"): any host
    synchronisation in it raises."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def count_syncs(fn):
    """The host synchronisations in ``fn()`` that torch's sync debug mode
    reports (a prototype: it may miss some), and where they are."""
    import collections
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where = collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
        if "called a synchronizing" in str(w.message))
    return sum(where.values()), dict(where)


def serpentine_scene(device):
    """Both hands' 3076 faces inside one 256-row band at 2048 px, every
    tile under the tile cap (tests/test_raster_pallas.py:272-305, drawn
    at 2048 px with focal 1000): the band overflows, the tiles do not."""
    import numpy as np
    import torch
    n_verts, cols = 778, 56
    i = np.arange(n_verts)
    xs = (-0.45 + 0.90 * (i % cols) / (cols - 1)).astype(np.float32)
    ys = (0.30 + 0.08 * (i // cols) / (n_verts // cols)
          + 0.002 * (i % 2)).astype(np.float32)
    verts = np.stack([xs, ys, np.zeros(n_verts, np.float32)], axis=1)
    f = np.arange(1538) % (n_verts - 2)
    faces = np.stack([f, f + 1, f + 2], axis=1)
    t = lambda a, **kw: torch.as_tensor(a, device=device, **kw)
    return (t(np.stack([verts, verts])),
            t([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]]), t([True, True]),
            t(np.stack([faces, faces]), dtype=torch.long))


def phase_kernels_banded():
    """The banded kernel against its plain version and the flat kernel
    at 2048 px, and the band-overflow dispatch on a hand-made scene, with
    the flat kernel on it against its plain version."""
    import torch
    from acr_tpu_torch.viz import raster as R
    from acr_tpu_torch.viz import raster_cuda as rc
    dev = torch.device("cuda")
    scene = rest_pose_scene(dev, SCENE_DEPTH["fits_hi"])
    screen, all_faces, attrs = R.prepare_scene(*scene, HI, 1265.0)
    mx_t, mx_b = (int(x) for x in rc.banded_overflow_stats(screen, all_faces,
                                                           HI, HI))
    if not R.banded_fits(screen, all_faces, HI):
        raise AssertionError(f"rest-pose scene does not fit the banded caps "
                             f"(max {mx_t} faces/tile, {mx_b} faces/band)")
    tri, inv = rc.face_rows(screen, all_faces)
    n = all_faces.shape[0]
    staged = rc.bin_faces_banded(
        rc.face_table(tri, attrs, inv), *rc.face_bboxes(tri), inv != 0.0, HI,
        HI, rc.COL_TILE, rc.BAND_H, min(rc.BAND_CAP, n), min(rc.BIN_CAP, n))
    args = (*staged, HI, HI, rc.COL_TILE, rc.BAND_H)
    got = rc.raster_banded(*args)
    err = _max_err(got, rc.raster_banded_plain(*args))
    flat = rc.raster_flat(tri, inv, attrs, HI, HI)
    torch.cuda.synchronize()
    if not all(torch.equal(g, f) for g, f in zip(got, flat)):
        raise AssertionError("banded kernel differs from the flat kernel")
    covered = int((got[0] >= 0).sum())
    rc.reset_launch_counts()
    R.render_hands(*scene, size=HI)
    took = {k: v for k, v in rc.LAUNCHES.items() if v}
    say("kernels", f"banded vs plain, rest-pose scene, {n} faces at {HI} px: "
        f"fid and attrs equal, bary max err {err:g} (tol: fid/attrs equal, "
        f"bary 1e-5); bit-identical to flat; {covered} covered pixels; max "
        f"{mx_t} faces/tile, {mx_b} faces/band; render_hands took {took}")
    if covered < HI * HI // 20 or took != {"raster_banded": 1}:
        raise AssertionError("banded scene check failed")

    o_scene = serpentine_scene(dev)
    probe = R.render_overflow_probe(*o_scene, size=HI, focal=1000.0).tolist()
    rc.reset_launch_counts()
    rgba = R.render_hands(*o_scene, size=HI, focal=1000.0)
    took = {k: v for k, v in rc.LAUNCHES.items() if v}
    drawn = int((rgba[..., 3] > 0).sum())
    say("kernels", f"band-overflow scene at {HI} px: probe [max faces/tile, "
        f"tiles over, max faces/band, bands over] = {probe}; render_hands "
        f"took {took}; {drawn} pixels drawn")
    if (probe[0] > rc.BIN_CAP or probe[1] or probe[2] <= rc.BAND_CAP
            or probe[3] < 1 or took != {"raster_flat": 1} or not drawn
            or not bool(torch.isfinite(rgba).all())):
        raise AssertionError("band-overflow dispatch check failed")

    f_screen, f_faces, f_attrs = R.prepare_scene(*o_scene, HI, 1000.0)
    f_tri, f_inv = rc.face_rows(f_screen, f_faces)
    flat_args = (f_tri, f_inv, f_attrs, HI, HI)
    flat_err = _max_err(rc.raster_flat(*flat_args),
                        rc.raster_flat_plain(*flat_args))
    say("kernels", f"raster_flat vs plain on that scene, {f_faces.shape[0]} "
        f"faces at {HI} px: fid and attrs equal, bary max err {flat_err:g} "
        "(tol: fid/attrs equal, bary 1e-5)")
    return err, flat_err


def phase_band_overflow(card, out_dir):
    """B2's path: one ACRApp.process_frame at render_size 2048 of the
    "far" hands moved into one 256-row band (the band holds both hands'
    3076 faces, above BAND_CAP), the launch counts zeroed just before it
    and read just after; then B2 against its plain version on that
    frame's scene, timed against its bound."""
    import numpy as np
    import torch
    from acr_tpu_torch.config import Config
    from acr_tpu_torch.pipeline.app import ACRApp
    from acr_tpu_torch.pipeline.preprocess import img_preprocess
    from acr_tpu_torch.viz import raster as R
    from acr_tpu_torch.viz import raster_cuda as rc
    cfg = Config(input_size=SIZE, render_size=HI, configs_yml="",
                 centermap_conf_thresh=-1e9, output_dir=out_dir)
    app = ACRApp(cfg, params=_weights(CAM_SCALE["far"], BAND_TY),
                 device="cuda")
    frame = (np.random.RandomState(1).rand(SIZE, SIZE, 3) * 255).astype(
        np.uint8)
    rc.reset_launch_counts()
    if importlib.util.find_spec("cv2") is not None:
        app.process_frame(frame, "band_overflow.jpg")
        out = app.last_output
    else:
        out = app.device_step(img_preprocess(frame, None, SIZE))
    took = {k: v for k, v in rc.LAUNCHES.items() if v}
    t = lambda k: torch.as_tensor(out[k][0]).cuda()
    scene = (t("verts"), t("cam_trans"), t("detection_flag"),
             app.visualizer.faces)
    probe = R.render_overflow_probe(*scene, size=HI,
                                    focal=app.cfg.focal_length).tolist()
    drawn = int((out["_rgba"][3] > 0).sum())
    say("band_overflow", f"{HI} px frame through ACRApp.process_frame, far "
        f"hands at ty {BAND_TY}: probe [max faces/tile, tiles over, max "
        f"faces/band, bands over] = {probe}; launches {took}; {drawn} pixels "
        "drawn")
    for k in ("verts", "j3d", "pj2d", "cam_trans", "_rgba"):
        if not np.isfinite(out[k]).all():
            raise AssertionError(f"non-finite {k}")
    if (out["_rgba"].shape != (4, HI, HI) or not drawn
            or not out["detection_flag"].all()):
        raise AssertionError("band-overflow frame: RGBA shape, empty render "
                             "or a hand not detected")
    if probe[2] <= rc.BAND_CAP or probe[3] < 1 or took != {"raster_flat": 1}:
        raise AssertionError("the band-overflow frame did not take raster_flat")

    # B2 where the app just took it
    f_screen, f_faces, f_attrs = R.prepare_scene(*scene, HI,
                                                 app.cfg.focal_length)
    f_tri, f_inv = rc.face_rows(f_screen, f_faces)
    flat_args = (f_tri, f_inv, f_attrs, HI, HI)
    flat_err = _max_err(rc.raster_flat(*flat_args),
                        rc.raster_flat_plain(*flat_args))
    flat = lambda: rc.raster_flat(*flat_args)
    hi = {"ms": cuda_ms(flat, iters=20)[0], "device_ms": graph_ms(flat, n=20),
          "err": flat_err, "launches": took["raster_flat"],
          "plain_ms": cuda_ms(lambda: rc.raster_flat_plain(*flat_args),
                              iters=1, reps=3, warmup=0)[0]}
    pairs = int(rc.flat_cull_mask(f_tri, f_inv, HI, HI).sum())
    hi["bound"] = flat_bound(f_faces.shape[0], pairs, HI, HI)
    brute = bound(4 * 26 * f_faces.shape[0] + PIXEL_OUT_BYTES * HI * HI,
                  EDGE_FLOPS * f_faces.shape[0] * HI * HI)
    say("band_overflow", f"raster_flat vs plain on that frame, "
        f"{f_faces.shape[0]} faces at {HI} px: fid and attrs equal, bary max "
        f"err {flat_err:g} (tol: fid/attrs equal, bary 1e-5); "
        f"{hi['ms']:.4f} ms per call (CUDA events), device {hi['device_ms']:.4f} "
        f"ms (20 launches in one CUDA graph), plain version "
        f"{hi['plain_ms']:.4f} ms; bound {hi['bound'][0]:.4f} ms "
        f"({hi['bound'][1]}; {pairs} live (face, block) pairs), brute force "
        f"of the TPU original {brute[0]:.4f} ms ({brute[1]}) [{card}]")
    return hi


def _weights(scale, ty=0.0):
    """init_params(seed 0), with the 1x1 fuse convs (which emit each
    hand's 109 parameters) and the prior heads' output convs scaled by
    0.05, and the fuse-conv biases set to the camera (scale, -+0.3, ty),
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
            torch.tensor([scale, tx, ty]), rot6d_identity, torch.zeros(10)])
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
    overflow = []
    for (name, i, out), took in zip(outs, paths):
        probe = R.render_overflow_probe(
            torch.as_tensor(out["verts"][0]), torch.as_tensor(out["cam_trans"][0]),
            torch.as_tensor(out["detection_flag"][0]),
            apps[name].visualizer.faces.cpu(), size=SIZE)
        overflow.append((name, i, int(probe[1])))
        say("main", f"{name} frame {i}: max {int(probe[0])} faces/tile, "
            f"{int(probe[1])} tiles above {rc.BIN_CAP} -> {took}; cam scale "
            f"{out['cam'][0, :, 0].round(3).tolist()}")
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
    if not launches["raster_binned"]:
        raise AssertionError("the main path never launched raster_binned")
    if launches["raster_flat"] or launches["raster_banded"]:
        raise AssertionError("the 512 px main path launched another "
                             f"rasterizer than B1: {launches}")
    far_over = [int(probe_over) for name, _, probe_over in overflow if
                name == "far"]
    if not all(far_over):
        raise AssertionError(f"far frames without overflow tiles: {far_over}")
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


def _stream_cfg(render_size, out_dir, **over):
    from acr_tpu_torch.config import Config
    kw = dict(input_size=SIZE, render_size=render_size, configs_yml="",
              centermap_conf_thresh=-1e9, demo_mode="webcam",
              temporal_optimization=True, output_dir=out_dir)
    kw.update(over)
    return Config(**kw)


def phase_stream(weights, out_dir):
    """The webcam stream path: StreamingLoop over 720p frames with -t,
    at render_size 2048 (the banded kernel) and then 512. The launch
    counts are zeroed just before each run and read just after it."""
    import numpy as np
    import torch
    from acr_tpu_torch.pipeline.app import ACRApp
    from acr_tpu_torch.pipeline.streaming import StreamingLoop, SyntheticSource
    from acr_tpu_torch.viz import raster as R
    from acr_tpu_torch.viz import raster_cuda as rc
    launches = {}
    for size in (HI, SIZE):
        app = ACRApp(_stream_cfg(size, out_dir, raster_overflow_every=1),
                     params=weights, device="cuda")
        state0 = [x.clone() for x in app.filter_state.left.pose]
        results = []
        loop = StreamingLoop(app, on_result=lambda img, out: results.append(
            (img, out)))
        rc.reset_launch_counts()
        t0 = time.perf_counter()
        n = loop.run(SyntheticSource(N_STREAM, *FRAME_HW, seed=0))
        wall = time.perf_counter() - t0
        launches[size] = dict(rc.LAUNCHES)
        scale = 4 if size > 1000 else 1
        for k, (img, out) in enumerate(results):
            probe = R.render_overflow_probe(
                *(torch.as_tensor(out[key][0]).cuda() for key in
                  ("verts", "cam_trans", "detection_flag")),
                app.visualizer.faces, size=size).tolist()
            say("stream", f"{size} px frame {k}: probe [max faces/tile, tiles "
                f"over, max faces/band, bands over] = {probe}; composited "
                f"{img.shape}")
            for key in ("verts", "j3d", "pj2d", "cam_trans", "poses", "_rgba"):
                if not np.isfinite(out[key]).all():
                    raise AssertionError(f"non-finite {key}")
            if out["verts"].shape != (1, 2, 778, 3):
                raise AssertionError("output shapes")
            if out["_rgba"].shape != (4, size, size) or not out["_rgba"][3].any():
                raise AssertionError(f"RGBA {out['_rgba'].shape}, or empty")
            if img.shape != (FRAME_HW[0] * scale, FRAME_HW[1] * scale, 3):
                raise AssertionError(f"composited frame {img.shape}")
            if not out["detection_flag"].all():
                raise AssertionError("both hands must be detected")
        st = app.filter_state
        moved = not all(torch.equal(a, b) for a, b in zip(st.left.pose, state0))
        if n != N_STREAM or not (bool(st.left.pose.initialized)
                                 and bool(st.right.pose.initialized) and moved):
            raise AssertionError("the OneEuro state did not advance")
        say("stream", f"{n} frames of {FRAME_HW[0]}x{FRAME_HW[1]} through "
            f"StreamingLoop, -t, render {size} px, in {wall:.2f} s (first "
            f"frames include set-up); launches {launches[size]}; loop p50 "
            f"{loop.p50_latency_ms():.3f} ms")
    if not launches[HI]["raster_banded"]:
        raise AssertionError("the 2048 px stream never launched raster_banded")
    if not launches[SIZE]["raster_binned"]:
        raise AssertionError("the 512 px stream never launched raster_binned")
    return launches[HI]


def _state_leaves(state):
    if isinstance(state, tuple):
        return [x for s in state for x in _state_leaves(s)]
    return [state.cpu().float()]


def phase_device_vs_cpu_t(weights, out_dir):
    """-t through process_frame on the card and on the CPU, same frames."""
    from acr_tpu_torch.pipeline.app import ACRApp
    from acr_tpu_torch.pipeline.streaming import SyntheticSource
    cfg = _stream_cfg(HI, out_dir, demo_mode="video")
    gpu = ACRApp(cfg, params=weights, device="cuda")
    cpu = ACRApp(dataclasses.replace(cfg, renderer="none"), params=weights,
                 device="cpu")
    errs = {"verts": 0.0, "j3d": 0.0, "pj2d": 0.0}
    for k, frame in enumerate(SyntheticSource(3, *FRAME_HW, seed=1).frames):
        gpu.process_frame(frame, f"t{k}.jpg")
        cpu.process_frame(frame, f"t{k}.jpg")
        for key in errs:
            errs[key] = max(errs[key], float(abs(
                gpu.last_output[key] - cpu.last_output[key]).max()))
    state_err = max(float((a - b).abs().max()) for a, b in zip(
        _state_leaves(gpu.filter_state), _state_leaves(cpu.filter_state)))
    say("device_vs_cpu", f"-t, 3 frames through process_frame: max abs err "
        f"{json.dumps(errs)}, OneEuro state {state_err:g} (tol 1e-4)")
    if max(errs.values()) > 1e-4 or state_err > 1e-4:
        raise AssertionError("-t: device and CPU disagree")


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

    # B1 as render_hands runs it (cap 512, unclipped counts, the face
    # table) on the main path's near frame (every tile fits), its far frame
    # and the rest-pose overflow scene (tiles above 512): bit for bit
    # against its plain version and B2, each timed beside B2 on the same
    # inputs, against its bound
    scenes = {"near": _main_path_scene(apps["near"]),
              "far": _main_path_scene(apps["far"]),
              "overflow": R.prepare_scene(*rest_pose_scene(
                  torch.device("cuda"), SCENE_DEPTH["overflows"]), SIZE,
                  1265.0)}
    b1, device, bounds = {}, {}, {}
    for name, (screen, faces, attrs) in scenes.items():
        tri, inv = rc.face_rows(screen, faces)
        args, table = binned_inputs(tri, inv, attrs, SIZE,
                                    min(rc.BIN_CAP, faces.shape[0]))
        binned = lambda: rc.raster_binned(*args, table=table)
        flat = lambda: rc.raster_flat(tri, inv, attrs, SIZE, SIZE)
        got, flat_out = binned(), flat()
        want = rc.raster_binned_plain(*args, table=table)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) and torch.equal(g, f)
                   for g, w, f in zip(got, want, flat_out)):
            raise AssertionError(f"B1 on the {name} frame differs from its "
                                 "plain version or from B2")
        counts = args[0]
        n_over = int((counts > rc.BIN_CAP).sum())
        if (n_over > 0) != (name != "near"):
            raise AssertionError(f"the {name} frame has {n_over} tiles "
                                 f"above {rc.BIN_CAP}")
        b_bound, live, pairs = binned_bound(tri, inv, counts, args[3], SIZE,
                                            SIZE, args[6])
        r = {"ms": cuda_ms(binned, iters=50), "device_ms": graph_ms(binned),
             "flat_ms": cuda_ms(flat, iters=50), "flat_device_ms": graph_ms(flat),
             "bound": b_bound, "max": int(counts.max()), "over": n_over,
             "live": live, "pairs": pairs}
        if name == "near":
            errs["raster_binned"] = 0.0          # equal bit for bit above
            times["raster_binned_plain"] = cuda_ms(
                lambda: rc.raster_binned_plain(*args, table=table), iters=5)
            bounds["raster_binned"] = b_bound
            device["raster_binned"] = r["device_ms"]
            times["raster_binned"] = r["ms"]
        b1[name] = r
        say("times", f"raster_binned on the {name} frame ({SIZE} px, "
            f"{faces.shape[0]} faces, max {r['max']} faces/tile, {n_over} "
            f"tiles above {rc.BIN_CAP}, {live} live (face, tile) pairs, "
            f"{pairs} folded (face, block) pairs): "
            f"equal to its plain version and to raster_flat bit for bit; "
            f"{ms_text(r['ms'])}; device {r['device_ms']:.4f} ms (50 launches "
            f"in one CUDA graph, median of 5 replays); bound "
            f"{b_bound[0]:.4f} ms ({b_bound[1]}); raster_flat on the same "
            f"inputs {r['flat_ms'][0]:.4f} ms, device "
            f"{r['flat_device_ms']:.4f} ms [{card}]")
    say("times", f"raster_binned_plain, near frame: "
        f"{ms_text(times['raster_binned_plain'])} [{card}]")

    # render_hands at 512 px as the app calls it: no host sync on either
    # frame, one B1 launch, and its time back to back and in a CUDA graph
    for name, app in apps.items():
        out = {k: torch.as_tensor(app.last_output[k]).cuda()
               for k in ("verts", "cam_trans", "detection_flag")}
        render = lambda: app.visualizer.render_rgba_device(out)
        render()                                         # warm-up
        rc.reset_launch_counts()
        sync_free(render)
        launched = {k: v for k, v in rc.LAUNCHES.items() if v}
        if launched != {"raster_binned": 1}:
            raise AssertionError(f"render_hands on the {name} frame: {launched}")
        t = cuda_ms(render, iters=20)
        times[f"render_{name}"] = t
        say("times", f"render_hands at {SIZE} px, {name} frame: no host sync "
            f"under set_sync_debug_mode('error'), launches {launched}; "
            f"{ms_text(t)}; device {graph_ms(render, n=20):.4f} ms (20 calls "
            f"in one CUDA graph) [{card}]")
    return {k: v[0] for k, v in times.items()}, errs, bounds, device, b1


def phase_times_stream(card, weights, out_dir):
    """The b1 stream step and the streaming loop at 512 and 2048 px, and
    the banded kernel, its plain version and its prestage at 2048 px on
    a frame of the stream."""
    import numpy as np
    import torch
    from acr_tpu_torch.pipeline.app import ACRApp
    from acr_tpu_torch.pipeline.preprocess import img_preprocess
    from acr_tpu_torch.pipeline.streaming import StreamingLoop, SyntheticSource
    from acr_tpu_torch.viz import raster as R
    from acr_tpu_torch.viz import raster_cuda as rc
    times = {}
    frame = SyntheticSource(1, *FRAME_HW, seed=3).read()
    meta = img_preprocess(frame, None, SIZE)
    for size in (SIZE, HI):
        app = ACRApp(_stream_cfg(size, out_dir), params=weights, device="cuda")
        times[f"stream_step_{size}"] = cuda_ms(lambda: app.stream_step(meta),
                                               iters=20)
        say("times", f"b1 fp32 stream step (forward + OneEuro + refine + "
            f"render {size} px): {ms_text(times[f'stream_step_{size}'])} "
            f"[{card}]")
        loop = StreamingLoop(app)
        loop.run(SyntheticSource(N_LOOP, *FRAME_HW, seed=4))
        lat = sorted(loop.latencies[2:])
        say("times", f"StreamingLoop host latency per frame ({FRAME_HW[0]}x"
            f"{FRAME_HW[1]} frames, -t, render {size} px, readback and "
            f"composite included): p50 {float(np.percentile(lat, 50)):.3f} ms, "
            f"min {lat[0]:.3f}, max {lat[-1]:.3f} over {len(lat)} frames "
            f"[{card}]")
    out = app.unpack_stream(app.stream_step(meta))
    t = lambda k: torch.as_tensor(out[k][0]).cuda()
    screen, faces, attrs = R.prepare_scene(
        t("verts"), t("cam_trans"), t("detection_flag"), app.visualizer.faces,
        HI, app.cfg.focal_length)
    if not R.banded_fits(screen, faces, HI):
        raise AssertionError("the stream frame should take the banded kernel")
    tri, inv = rc.face_rows(screen, faces)
    n = faces.shape[0]
    stage = lambda: rc.bin_faces_banded(
        rc.face_table(tri, attrs, inv), *rc.face_bboxes(tri), inv != 0.0, HI,
        HI, rc.COL_TILE, rc.BAND_H, min(rc.BAND_CAP, n), min(rc.BIN_CAP, n))
    args = (*stage(), HI, HI, rc.COL_TILE, rc.BAND_H)
    err = _max_err(rc.raster_banded(*args), rc.raster_banded_plain(*args))
    for name, fn, iters in (
            ("banded_prestage", stage, 20),
            ("raster_banded", lambda: rc.raster_banded(*args), 50),
            ("raster_banded_plain", lambda: rc.raster_banded_plain(*args), 3)):
        times[name] = cuda_ms(fn, iters=iters)
        if name == "raster_banded":
            device = graph_ms(fn)
        say("times", f"{name} ({HI} px, {n} faces, the stream's frame, max "
            f"{int(args[2].max()) * rc.FACE_CHUNK} slots/tile bound): "
            f"{ms_text(times[name])}"
            + (f"; device {device:.4f} ms (CUDA graph)" if name ==
               "raster_banded" else "") + f" [{card}]")
    # bound on these inputs: the live band-table columns (32 rows) and
    # tile slots read once, the live slots folded over their tile's pixels
    table, ids_t, tilenc = args[0], args[1], args[2]
    live_cols = int((table[:, rc.ROW_GID] >= 0).sum())
    live_slots = int((ids_t < table.shape[2]).sum())
    b_ms, b_by = bound(4 * (32 * live_cols + live_slots + tilenc.numel())
                       + PIXEL_OUT_BYTES * HI * HI,
                       EDGE_FLOPS * live_slots * rc.ROW_TILE * rc.COL_TILE)
    say("times", f"raster_banded bound on these inputs: {b_ms:.4f} ms "
        f"({b_by}; {live_cols} live table columns, {live_slots} live slots)")
    return {k: v[0] for k, v in times.items()}, err, (b_ms, b_by), device


# kernel vs plain: partial and whole blocks of 8 hands, 1 to 512 blocks
MANO_BATCHES = (1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 1024, 4096)
MANO_SWEEP = (8, 64, 256, 512, 1024, 4096)         # pure vs fused, threshold
N_THROUGHPUT = 20             # 720p frames of the throughput run
CHUNK = 8                     # val_batch_size of the throughput path


def _mano_inputs(batch, seed, device):
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    poses = torch.from_numpy((rng.randn(batch, 48) * 0.5).astype(np.float32))
    betas = torch.from_numpy((rng.randn(batch, 10) * 0.7).astype(np.float32))
    return poses.to(device), betas.to(device)


def _mano_sides(device):
    from acr_tpu_torch.config import Config
    from acr_tpu_torch.models.mano import load_mano_model
    from acr_tpu_torch.ops.mano_kernel import build_kernel_data
    sides = {}
    for side in ("left", "right"):
        model, _ = load_mano_model(Config().mano_model_path, side,
                                   device=device)
        sides[side] = (model, build_kernel_data(model))
    return sides


def phase_kernels_mano():
    """B4 against its plain version on the card, both sides, at every
    batch of MANO_BATCHES; the fused forward against the pure one; the
    ManoAuto dispatch at the threshold."""
    import torch
    from acr_tpu_torch.models.mano import mano_forward
    from acr_tpu_torch.ops import mano_kernel as mk
    from acr_tpu_torch.pipeline import infer
    dev = torch.device("cuda")
    err = fwd_err = 0.0
    sides = _mano_sides(dev)
    for k, (model, data) in enumerate(sides.values()):
        for batch in MANO_BATCHES:
            poses, betas = _mano_inputs(batch, 100 * k + batch, dev)
            coef, g_rows, _ = mk.blend_skin_operands(data, poses, betas)
            got = mk.fused_blend_skin(data, coef, g_rows)
            want = mk.fused_blend_skin_plain(data, coef, g_rows)
            torch.cuda.synchronize()
            err = max(err, float((got - want).abs().max()))
        poses, betas = _mano_inputs(65, k, dev)
        for center in (9, None):
            fused = mk.mano_forward_fused(data, poses, betas, center_idx=center)
            pure = mano_forward(model, poses, betas, center_idx=center)
            fwd_err = max(fwd_err, *(float((a - b).abs().max()) for a, b in
                                     zip(fused, pure) if a is not None))
    # the sums of the kernel and of cuBLAS run in different orders, so
    # this is a tolerance, not a bit-for-bit check
    say("kernels", f"mano_fused vs plain, both sides, B in {MANO_BATCHES}: "
        f"verts max abs err {err:g} (tol 1e-5, fp32 sums in another "
        f"order); mano_forward_fused vs mano_forward (center 9 and None, "
        f"B 65): {fwd_err:g} (tol 1e-5)")
    if err > 1e-5 or fwd_err > 1e-5:
        raise AssertionError("mano_fused disagrees with its plain version")
    auto = infer.ManoAuto(*sides["right"])
    thr = infer.PALLAS_MANO_MIN_BATCH
    took = {}
    for batch in (thr - 1, thr):
        poses, betas = _mano_inputs(batch, batch, dev)
        mk.reset_launch_counts()
        infer._apply_mano(auto, poses, betas, 9)
        took[batch] = mk.LAUNCHES["mano_fused"]
    say("kernels", f"ManoAuto at PALLAS_MANO_MIN_BATCH = {thr}: mano_fused "
        f"launches {took[thr]} at B {thr}, {took[thr - 1]} at B {thr - 1}")
    if took != {thr - 1: 0, thr: 1}:
        raise AssertionError(f"ManoAuto dispatch: {took}")
    return err


def _throughput_cfg(frames_dir, out_dir, **over):
    from acr_tpu_torch.config import Config
    kw = dict(input_size=SIZE, render_size=SIZE, configs_yml="",
              centermap_conf_thresh=-1e9, demo_mode="folder",
              inputs=frames_dir, val_batch_size=CHUNK,
              temporal_optimization=True, use_pallas_mano="on",
              save_dict_results=True, raster_overflow_every=1,
              output_dir=out_dir)
    kw.update(over)
    return Config(**kw)


def _write_frames(frames_dir):
    import cv2
    import numpy as np
    os.makedirs(frames_dir, exist_ok=True)
    rng = np.random.RandomState(20)
    for i in range(N_THROUGHPUT):
        frame = (rng.rand(*FRAME_HW, 3) * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(frames_dir, f"{i:06d}.jpg"), frame)


def phase_throughput(weights, frames_dir, out_dir):
    """The throughput path: ACRApp.run_folder over N_THROUGHPUT 720p
    JPEG frames at val_batch_size 8 (three chunks, the last one padded),
    -t, the fused MANO kernel, render 512. The launch counts are zeroed
    just before the run and read just after it."""
    import numpy as np
    import torch
    from acr_tpu_torch.ops import mano_kernel as mk
    from acr_tpu_torch.pipeline.app import ACRApp
    from acr_tpu_torch.viz import raster_cuda as rc
    _write_frames(frames_dir)
    app = ACRApp(_throughput_cfg(frames_dir, out_dir), params=weights,
                 device="cuda")
    state0 = [x.clone() for x in app.filter_state.right.pose]
    rc.reset_launch_counts()
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    results = app.run_folder()
    wall = time.perf_counter() - t0
    launches = {**rc.LAUNCHES, **mk.LAUNCHES}
    outs = os.listdir(out_dir)
    n_jpg = sum(o.endswith(".jpg") for o in outs)
    n_mp4 = sum(o.endswith(".mp4") for o in outs)
    n_pkl = sum(o.endswith(".pkl") for o in outs)
    n_chunks = -(-N_THROUGHPUT // CHUNK)
    say("throughput", f"{len(results)} results of {N_THROUGHPUT} frames of "
        f"{FRAME_HW[0]}x{FRAME_HW[1]} in {n_chunks} chunks of {CHUNK} "
        f"(folder mode, -t, use_pallas_mano on, render {SIZE} px) in "
        f"{wall:.2f} s with set-up; launches {launches}; written: {n_jpg} "
        f"frames, {n_mp4} mp4, {n_pkl} pkl")
    for path, hands in results.items():
        if len(hands) != 2:
            raise AssertionError(f"{path}: {len(hands)} hands detected")
        for hand in hands:
            for key, v in hand.items():
                if not np.isfinite(np.asarray(v, np.float32)).all():
                    raise AssertionError(f"{path}: non-finite {key}")
    last = app.last_output
    for key in ("verts", "j3d", "pj2d", "cam_trans", "poses", "_rgba"):
        if not np.isfinite(last[key]).all():
            raise AssertionError(f"non-finite {key} in the last chunk")
    if last["_rgba"].shape[1:] != (4, SIZE, SIZE) or not last["_rgba"][:, 3].any():
        raise AssertionError("the last chunk's render is empty")
    st = app.filter_state
    moved = not all(torch.equal(a, b) for a, b in zip(st.right.pose, state0))
    if not (bool(st.left.pose.initialized) and bool(st.right.pose.initialized)
            and moved):
        raise AssertionError("the OneEuro state did not advance")
    if (len(results) != N_THROUGHPUT or n_jpg != N_THROUGHPUT or n_mp4 != 1
            or n_pkl != 1):
        raise AssertionError("the throughput run did not write every output")
    if launches["mano_fused"] != 4 * n_chunks:
        raise AssertionError(f"mano_fused launched {launches['mano_fused']} "
                             f"times, want 4 per chunk")
    if not launches["raster_binned"]:
        raise AssertionError("the throughput run never launched raster_binned")
    return launches, app


def _chunk_inputs(frames_dir, n):
    import cv2
    import numpy as np
    from acr_tpu_torch.pipeline.preprocess import img_preprocess
    names = sorted(os.listdir(frames_dir))[:n]
    metas = [img_preprocess(cv2.imread(os.path.join(frames_dir, p)), p,
                            input_size=SIZE) for p in names]
    return (np.concatenate([m["image"] for m in metas]),
            np.concatenate([m["offsets"] for m in metas]))


def phase_device_vs_cpu_chunk(weights, frames_dir, out_dir):
    """One chunk step with -t and the fused MANO path on the card and on
    the CPU, same frames and weights."""
    from acr_tpu_torch.pipeline.app import ACRApp
    image, offsets = _chunk_inputs(frames_dir, CHUNK)
    cfg = _throughput_cfg(frames_dir, out_dir, raster_overflow_every=0)
    gpu = ACRApp(cfg, params=weights, device="cuda")
    cpu = ACRApp(dataclasses.replace(cfg, renderer="none"), params=weights,
                 device="cpu")
    g = {k: v.cpu() for k, v in gpu.chunk_step(image, offsets).items()}
    t0 = time.perf_counter()
    c = cpu.chunk_step(image, offsets)
    cpu_s = time.perf_counter() - t0
    errs = {k: float((g[k] - c[k]).abs().max()) for k in ("verts", "j3d",
                                                          "pj2d")}
    state_err = max(float((a - b).abs().max()) for a, b in zip(
        _state_leaves(gpu.filter_state), _state_leaves(cpu.filter_state)))
    say("device_vs_cpu", f"-t, one chunk of {CHUNK} frames through "
        f"chunk_step (use_pallas_mano on): max abs err {json.dumps(errs)}, "
        f"OneEuro state {state_err:g} (tol 1e-4); the CPU side took "
        f"{cpu_s:.2f} s")
    if max(errs.values()) > 1e-4 or state_err > 1e-4:
        raise AssertionError("chunk step: device and CPU disagree")


def _self_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def device_profile(fn, calls=3):
    """(device events, device ms, the events) per call of ``fn`` by
    torch.profiler. The device's own events (kernels, copies) are
    counted, not the operators that launched them, so no time is counted
    twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    return (sum(e.count for e in events) / calls,
            sum(_self_us(e) for e in events) / calls / 1e3, events)


def _chunk_breakdown(card, app, image, offsets, smooth_sequence):
    """Where the b8 chunk step's time goes: each stage alone by CUDA
    events, and the device's busy time in one step by torch.profiler
    (summed device-event time) against their unprofiled time."""
    import torch
    dev = app.pipeline.device
    img = torch.as_tensor(image).to(dev)
    off = torch.as_tensor(offsets, dtype=torch.float32).to(dev)
    with torch.no_grad():
        out = app.pipeline(img, off)
        state = app.filter_state
        stages = {
            "forward": lambda: app.pipeline(img, off),
            "oneeuro": lambda: smooth_sequence(
                state, out["poses"], out["betas"], out["detection_flag"],
                app.cfg.smooth_coeff),
            "refine": lambda: app.pipeline.refine(out["poses"], out["betas"],
                                                  out["cam"], off),
            "renders": lambda: [app.visualizer.render_rgba_device(out, k)
                                for k in range(CHUNK)],
        }
        for name, fn in stages.items():
            say("times", f"b{CHUNK} chunk step stage {name}: "
                f"{ms_text(cuda_ms(fn, iters=5, reps=3, warmup=1))} [{card}]")
    step = lambda: app.chunk_step(image, offsets)
    n_syncs, where = count_syncs(step)
    say("times", f"b{CHUNK} chunk step: {n_syncs} host syncs left (torch's "
        f"sync debug mode, 'warn'), at {json.dumps(where)}")
    unprofiled = cuda_ms(step, iters=3, reps=3, warmup=1)[0]
    n_events, busy, events = device_profile(step, calls=1)
    top = sorted(events, key=_self_us, reverse=True)[:5]
    say("times", f"b{CHUNK} chunk step under torch.profiler: {n_events:.0f} "
        f"device events per step, device busy {busy:.3f} ms per step "
        f"against {unprofiled:.3f} ms unprofiled (idle share "
        f"{1 - busy / unprofiled:.3f}); top device events (ms per step): "
        + "; ".join(f"{e.key[:60]} {_self_us(e) / 1e3:.3f}" for e in top)
        + f" [{card}]")


def _wrapper_host_parts(card, data, coef, g_rows):
    """Where B4's host issue goes: the wrapper against its parts, each
    issued back to back (host_issue_ms)."""
    import torch
    from acr_tpu_torch.ops import cuda_lib
    from acr_tpu_torch.ops import mano_kernel as mk
    b, dev = coef.shape[0], coef.device
    out = torch.empty((b, mk.N_VERTS, 3), device=dev)
    fn = cuda_lib.library().acr_mano_fused
    args = (coef.data_ptr(), g_rows.data_ptr(), data.basis.data_ptr(),
            data.weights_t.data_ptr(), b, out.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    parts = {
        "fused_blend_skin": lambda: mk.fused_blend_skin(data, coef, g_rows),
        "cuda_lib.launch": lambda: cuda_lib.launch(fn, dev, *args),
        "ctypes call": lambda: fn(*args, stream),
        "torch.empty": lambda: torch.empty((b, mk.N_VERTS, 3), device=dev),
        "operand checks": lambda: (
            cuda_lib.check("coef", coef, torch.float32, (b, mk.N_COEF), dev),
            cuda_lib.check("g_rows", g_rows, torch.float32, (b * 12, 16), dev),
            mk._check_constants(data, dev)),
        "launch_shape": lambda: mk.launch_shape(b),
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "raw stream": lambda: cuda_lib._current_stream(
            torch.cuda.current_device()),
    }
    say("times", f"B4 host issue at B {b}, ms per call (min of 3 runs of "
        "200): " + "; ".join(f"{k} {min(host_issue_ms(f) for _ in range(3)):.4f}"
                             for k, f in parts.items()) + f" [{card}]")


def phase_times_throughput(card, weights, frames_dir, app):
    """The b8 chunk step (with and without -t, fused MANO on and off),
    the folder-mode frame rate over warmed chunks, and B4 against its
    plain version, its yardstick and the pure MANO forward."""
    import torch
    from acr_tpu_torch.models.mano import mano_forward
    from acr_tpu_torch.ops import mano_kernel as mk
    from acr_tpu_torch.pipeline import infer
    from acr_tpu_torch.pipeline.app import ACRApp
    from acr_tpu_torch.pipeline.temporal import smooth_sequence
    from acr_tpu_torch.utils.meters import StageTimer
    times = {}
    image, offsets = _chunk_inputs(frames_dir, CHUNK)
    for t in (True, False):
        for mode in ("on", "off"):
            chunk_app = ACRApp(_throughput_cfg(
                frames_dir, None, temporal_optimization=t,
                use_pallas_mano=mode, raster_overflow_every=0),
                params=weights, device="cuda")
            name = f"chunk_step_t{int(t)}_{mode}"
            times[name] = cuda_ms(lambda: chunk_app.chunk_step(image, offsets),
                                  iters=3, reps=3, warmup=1)
            say("times", f"b{CHUNK} fp32 chunk step (forward{' + OneEuro + '
                'refine' if t else ''} + {CHUNK} renders at {SIZE} px), "
                f"use_pallas_mano {mode}: {ms_text(times[name])} [{card}]")
            if t and mode == "on":
                _chunk_breakdown(card, chunk_app, image, offsets,
                                 smooth_sequence)
            del chunk_app

    # folder mode by host wall over warmed chunks: the throughput app
    # again, its timer reset
    from acr_tpu_torch.io.writers import collect_image_list
    files = collect_image_list(frames_dir)
    app.timer = StageTimer()
    t0 = time.perf_counter()
    app._run_batched(files)
    wall = time.perf_counter() - t0
    report = {k: round(v["avg_ms"], 3) for k, v in app.timer.report().items()}
    say("times", f"folder mode, {len(files)} warmed {FRAME_HW[0]}x"
        f"{FRAME_HW[1]} frames at val_batch_size {CHUNK} (decode, chunk "
        f"step, readback, composite, write): {len(files) / wall:.3f} "
        f"frames/s ({wall:.3f} s); StageTimer avg ms {json.dumps(report)} "
        f"[{card}]")

    dev = torch.device("cuda")
    model, data = _mano_sides(dev)["right"]
    basis2d = data.basis.reshape(mk.N_COEF, -1)
    device = {}
    for batch in (8, 16, 1024):
        poses, betas = _mano_inputs(batch, batch, dev)
        coef, g_rows, _ = mk.blend_skin_operands(data, poses, betas)
        for name, fn in (
                ("mano_fused", lambda: mk.fused_blend_skin(data, coef, g_rows)),
                ("mano_fused_plain",
                 lambda: mk.fused_blend_skin_plain(data, coef, g_rows)),
                ("mano_library", lambda: (torch.matmul(coef, basis2d),
                                          torch.matmul(g_rows,
                                                       data.weights_t)))):
            key = f"{name}_{batch}"
            times[key] = cuda_ms(fn, iters=50)
            extra = ""
            if name != "mano_fused_plain":
                device[key] = graph_ms(fn)
                extra = (f"; device {device[key]:.4f} ms (50 calls in one "
                         "CUDA graph, median of 5 replays)")
            if name == "mano_fused":
                extra += (f"; host issue {host_issue_ms(fn):.4f} ms per call "
                          f"(launch shape {tuple(mk.launch_shape(batch))})")
            say("times", f"{name} at B {batch}: {ms_text(times[key])}{extra} "
                f"[{card}]")
        b_ms, b_by = mano_bound(batch)
        say("times", f"mano_fused bound at B {batch}: {b_ms:.5f} ms ({b_by})")
        if batch == CHUNK:
            _wrapper_host_parts(card, data, coef, g_rows)

    # the switch point. Both paths are bound by their launches at small
    # B, where the host's noise between windows is as large as their
    # difference: each path is timed twice by CUDA events, in the order
    # pure, fused, fused, pure, and its device events and device time
    # per call are counted by torch.profiler. The fused path is no slower
    # where it launches no more and its device time is no longer.
    sweep = {}
    for batch in MANO_SWEEP:
        poses, betas = _mano_inputs(batch, batch, dev)
        fns = {"pure": lambda: mano_forward(model, poses, betas),
               "fused": lambda: mk.mano_forward_fused(data, poses, betas)}
        windows = {"pure": [], "fused": []}
        for name in ("pure", "fused", "fused", "pure"):
            windows[name] += cuda_ms(fns[name], iters=10, reps=3,
                                     warmup=1)[4]
        med = {k: sorted(w)[len(w) // 2] for k, w in windows.items()}
        prof = {k: device_profile(fn)[:2] for k, fn in fns.items()}
        sweep[batch] = (med, prof)
        say("times", f"MANO forward at B {batch} hands (CUDA events, median "
            "of 6 windows [min, max]; torch.profiler, per call): " + "; ".join(
                f"{k} {med[k]:.4f} [{min(windows[k]):.4f}, "
                f"{max(windows[k]):.4f}] ms, {prof[k][0]:.0f} device events, "
                f"{prof[k][1]:.4f} ms device time" for k in fns)
            + f" [{card}]")

    def switch(no_slower):
        ok = [b for b in MANO_SWEEP
              if all(no_slower(c) for c in MANO_SWEEP if c >= b)]
        return ok[0] if ok else "never"
    by_device = switch(lambda b: all(
        f <= p for f, p in zip(sweep[b][1]["fused"], sweep[b][1]["pure"])))
    by_wall = switch(lambda b: sweep[b][0]["fused"] <= sweep[b][0]["pure"])
    say("times", f"the fused path launches no more and has no more device "
        f"time than the pure one at every B of the sweep {MANO_SWEEP} from "
        f"B = {by_device}; its CUDA-event median is no slower from B = "
        f"{by_wall} (PALLAS_MANO_MIN_BATCH is {infer.PALLAS_MANO_MIN_BATCH}) "
        f"[{card}]")
    return {k: v[0] for k, v in times.items()}, device


# ---- the precision paths (bf16, W8A8 int8) and the auxiliary views ----
# the budget of tests/test_quant.py:160-197: mean per-vertex displacement
# of an int8 run against the same run in float, over the hand's bbox
# diagonal
INT8_BUDGET = 0.01
# bf16 against the port's bf16 on the CPU and against the card's fp32:
# verts max abs err (m). Measured 2.3e-7 and 4.8e-5 (the fp32 run picked
# another centre on a near-tie) on an H100 80GB HBM3 at 700 W
BF16_VERTS_TOL = {"cpu": 1e-3, "fp32": 1e-3}
CHUNK_INT8 = 16               # val_batch_size of the bf16+int8 throughput run
AUX_ITEMS = ("org_img", "pj2d", "centermap", "j3d")


def _launch_counts():
    from acr_tpu_torch.ops import mano_kernel as mk
    from acr_tpu_torch.viz import raster_cuda as rc
    return {**rc.LAUNCHES, **mk.LAUNCHES}


def _reset_launch_counts():
    from acr_tpu_torch.ops import mano_kernel as mk
    from acr_tpu_torch.viz import raster_cuda as rc
    rc.reset_launch_counts()
    mk.reset_launch_counts()


def phase_int8_conv(card):
    """int8_conv2d against its plain version, bit for bit, at every
    quantized conv of the 512 px net at b1 (collected by forward
    pre-hooks during one forward of the int8 network, calibrated at load
    on the committed frames), and its time per distinct shape beside the
    bf16 cuDNN convolution of the same shape (the library comparison:
    JAX's int8 convolution is an XLA op, not a Pallas kernel)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from acr_tpu_torch.config import Config
    from acr_tpu_torch.ops import quant as tq
    from acr_tpu_torch.pipeline.infer import ACRPipeline
    t0 = time.perf_counter()
    pipe = ACRPipeline(Config(input_size=SIZE, configs_yml="",
                              quantize="int8"),
                       params=_weights(CAM_SCALE["near"]), device="cuda")
    sites = []

    def grab(mod, args):
        sites.append((mod.quantize(args[0]), mod.kernel_q, mod.stride,
                      mod.pad))
    hooks = [m.register_forward_pre_hook(grab) for m in pipe.net.modules()
             if isinstance(m, tq.QuantConv)]
    image = (np.random.RandomState(0).rand(1, SIZE, SIZE, 3) * 255).astype(
        np.uint8)
    with torch.no_grad():
        pipe.net(torch.as_tensor(image).cuda())
    for h in hooks:
        h.remove()
    shapes = {}
    for xq, k, s, p in sites:
        got = tq.int8_conv2d(xq, k, s, p)
        if not torch.equal(got, tq.int8_conv2d_plain(xq, k, s, p)):
            raise AssertionError(f"int8_conv2d differs from its plain "
                                 f"version at {tuple(xq.shape)} x "
                                 f"{tuple(k.shape)}, stride {s}")
        key = (tuple(xq.shape), tuple(k.shape), s, p)
        shapes.setdefault(key, [0, xq, k])[0] += 1
    say("int8", f"int8_conv2d vs plain (float64 conv of the integers) at "
        f"all {len(sites)} quantized convs of the {SIZE} px net, b1: int32 "
        f"equal bit for bit ({len(shapes)} distinct shapes)")
    if len(sites) != 338:
        raise AssertionError(f"{len(sites)} quantized convs, want 338")
    total = {"int8": 0.0, "bf16": 0.0}
    rows = []
    for (xs, ks, s, p), (n, xq, k) in sorted(shapes.items(),
                                             key=lambda kv: -kv[1][0]):
        xb, kb = xq.bfloat16(), k.bfloat16()
        t_i = cuda_ms(lambda: tq.int8_conv2d(xq, k, s, p), iters=20, reps=3)[0]
        t_b = cuda_ms(lambda: F.conv2d(xb, kb, stride=s, padding=p),
                      iters=20, reps=3)[0]
        total["int8"] += n * t_i
        total["bf16"] += n * t_b
        rows.append(f"{xs[1]}x{xs[2]}x{xs[3]}->{ks[0]} k{ks[2]} s{s} "
                    f"(x{n}): {t_i:.4f} / {t_b:.4f}")
    say("int8", "int8_conv2d / bf16 cuDNN conv of the same shape, ms per "
        "call (CUDA events, median of 3 windows of 20), per distinct shape "
        "[Ci x H x W -> Co, kernel, stride, sites]: " + "; ".join(rows)
        + f" [{card}]")
    say("int8", f"summed over the {len(sites)} sites: int8_conv2d "
        f"{total['int8']:.3f} ms, bf16 cuDNN {total['bf16']:.3f} ms "
        f"({time.perf_counter() - t0:.1f} s) [{card}]")
    return total


def _budget(ref, out):
    """(mean per-vertex displacement over the bbox diagonal, flipped
    detection flags) of ``out`` against ``ref`` (tests/test_quant.py)."""
    import numpy as np
    fv = np.asarray(ref["verts"], np.float64)
    qv = np.asarray(out["verts"], np.float64)
    disp = np.linalg.norm(qv - fv, axis=-1)
    diag = np.linalg.norm(fv.max(-2) - fv.min(-2), axis=-1)
    rel = disp / np.maximum(diag[..., None], 1e-9)
    flips = int((np.asarray(out["detection_flag"])
                 != np.asarray(ref["detection_flag"])).sum())
    return float(rel.mean()), float(rel.max()), flips


def _image_run(app, frames, tag):
    """Every frame through ACRApp.process_frame (device_step without cv2),
    the launch counts zeroed just before and read just after; returns the
    host outputs and the launches."""
    from acr_tpu_torch.pipeline.preprocess import img_preprocess
    has_cv2 = importlib.util.find_spec("cv2") is not None
    outs = []
    _reset_launch_counts()
    for i, frame in enumerate(frames):
        if has_cv2:
            app.process_frame(frame, f"{tag}_{i}.jpg")
            outs.append(app.last_output)
        else:
            outs.append(app.device_step(img_preprocess(frame, None, SIZE)))
    return outs, {k: v for k, v in _launch_counts().items() if v}


def _check_image_outs(outs, launches, what):
    import numpy as np
    for out in outs:
        for k in ("verts", "j3d", "pj2d", "cam_trans", "_rgba"):
            if not np.isfinite(out[k]).all():
                raise AssertionError(f"{what}: non-finite {k}")
        if out["verts"].shape != (1, 2, 778, 3) or not out["detection_flag"].all():
            raise AssertionError(f"{what}: output shape or a hand missed")
        if not out["_rgba"][3].any():
            raise AssertionError(f"{what}: the render drew nothing")
    if launches.get("raster_binned", 0) != len(outs) or set(launches) != {
            "raster_binned"}:
        raise AssertionError(f"{what}: launches {launches}, want one "
                             "raster_binned per frame")


def phase_bf16(card, apps, frames, out_dir):
    """The bf16 image path at b1, 512 px, "near" weights: ACRApp over the
    main path's frames (launch counts zeroed just before, read just
    after); against the port's bf16 on the CPU and against the card's own
    fp32 (the main path's app): the same detection flags and verts within
    BF16_VERTS_TOL; the b1 device step and the device_step wall beside
    fp32's, in turns (fp32, bf16, bf16, fp32)."""
    import numpy as np
    import torch
    from acr_tpu_torch.config import Config
    from acr_tpu_torch.pipeline.app import ACRApp
    from acr_tpu_torch.pipeline.infer import ACRPipeline
    from acr_tpu_torch.pipeline.preprocess import img_preprocess
    t0 = time.perf_counter()
    cfg = Config(input_size=SIZE, render_size=SIZE, configs_yml="",
                 centermap_conf_thresh=-1e9, output_dir=out_dir,
                 model_precision="bf16")
    weights = _weights(CAM_SCALE["near"])
    app = ACRApp(cfg, params=weights, device="cuda")
    outs, launches = _image_run(app, frames, "bf16")
    _check_image_outs(outs, launches, "bf16 image path")
    fp32 = apps["near"]
    meta = img_preprocess(frames[0], None, SIZE)
    cpu = ACRPipeline(cfg, params=weights, device="cpu")(meta["image"],
                                                         meta["offsets"])
    ref = {"cpu": {k: v.numpy() for k, v in cpu.items()},
           "fp32": fp32.device_step(meta)}
    got = app.device_step(meta)
    errs = {}
    for name, want in ref.items():
        same_flags = np.array_equal(got["detection_flag"],
                                    want["detection_flag"])
        errs[name] = float(np.abs(got["verts"] - want["verts"]).max())
        same_centers = np.array_equal(got["centers"], want["centers"])
        say("bf16", f"bf16 on the card vs {name}: detection flags equal "
            f"{same_flags}, centres equal {same_centers}, verts max abs err "
            f"{errs[name]:.3e} m (tol {BF16_VERTS_TOL[name]:g}), betas max "
            f"abs err {float(np.abs(got['betas'] - want['betas']).max()):.3e}")
        if not same_flags or errs[name] > BF16_VERTS_TOL[name]:
            raise AssertionError(f"bf16 vs {name}")
    image = torch.as_tensor(meta["image"]).cuda()
    offsets = torch.as_tensor(meta["offsets"]).cuda()
    times = {}
    for name in ("fp32", "bf16", "bf16", "fp32"):
        a = app if name == "bf16" else fp32

        def step():
            with torch.no_grad():
                out = a.pipeline(image, offsets)
                a.visualizer.render_rgba_device(out)
        t = cuda_ms(step, iters=10, reps=3)[0]
        walls = []
        for i in range(13):
            w0 = time.perf_counter()
            a.device_step(meta)
            if i >= 3:
                walls.append((time.perf_counter() - w0) * 1e3)
        times.setdefault(name, []).append((t, sorted(walls)[5]))
    say("bf16", f"b1 {SIZE} px device step (forward + render, CUDA events, "
        "median of 3 windows of 10) and ACRApp.device_step host wall (median "
        "of 10), runs in the order fp32, bf16, bf16, fp32: " + "; ".join(
            f"{k} " + ", ".join(f"{s:.3f} / {w:.3f} ms" for s, w in v)
            for k, v in times.items()) + f"; launches {launches} "
        f"({time.perf_counter() - t0:.1f} s) [{card}]")
    return launches, times


def phase_int8(card, frames, out_dir):
    """W8A8 at 512 px, calibrated at load on the committed frames: the
    image path in bf16+int8 (as bench.py serves it) over the main path's
    frames, the launch counts zeroed just before and read just after; the
    output-space budget of int8 and int8_pc in bf16 and of int8 in fp32
    against the same precision in float, on pipelines at the default 0.35
    threshold (so the flags are real); int8_r and int4w once each in bf16,
    finite, their budget printed, not asserted."""
    import numpy as np
    from acr_tpu_torch.config import Config
    from acr_tpu_torch.pipeline.app import ACRApp
    from acr_tpu_torch.pipeline.infer import ACRPipeline
    from acr_tpu_torch.pipeline.preprocess import img_preprocess
    t0 = time.perf_counter()
    weights = _weights(CAM_SCALE["near"])
    base = dict(input_size=SIZE, render_size=SIZE, configs_yml="",
                output_dir=out_dir)
    app = ACRApp(Config(model_precision="bf16", quantize="int8",
                        centermap_conf_thresh=-1e9, **base),
                 params=weights, device="cuda")
    outs, launches = _image_run(app, frames, "int8")
    _check_image_outs(outs, launches, "bf16+int8 image path")
    del app
    metas = [img_preprocess(f, None, SIZE) for f in frames]
    run = lambda pipe: [{k: v.cpu().numpy() for k, v in pipe(
        m["image"], m["offsets"]).items()} for m in metas]
    refs = {p: run(ACRPipeline(Config(model_precision=p, **base),
                               params=weights, device="cuda"))
            for p in ("fp32", "bf16")}
    budgets = {}
    for prec, mode in (("bf16", "int8"), ("bf16", "int8_pc"),
                       ("fp32", "int8"), ("bf16", "int8_r"),
                       ("bf16", "int4w")):
        name = f"{prec}+{mode}"
        asserted = mode in ("int8", "int8_pc")
        outs = run(ACRPipeline(Config(model_precision=prec, quantize=mode,
                                      **base), params=weights, device="cuda"))
        rels, maxes, flips = [], [], 0
        for out, ref in zip(outs, refs[prec]):
            for k in ("verts", "j3d", "cam_trans", "poses", "betas"):
                if not np.isfinite(out[k]).all():
                    raise AssertionError(f"{name}: non-finite {k}")
            rel, mx, flip = _budget(ref, out)
            rels.append(rel)
            maxes.append(mx)
            flips += flip
        n_det = sum(int(r["detection_flag"].sum()) for r in refs[prec])
        budgets[name] = (float(np.mean(rels)), max(maxes), flips)
        say("int8", f"{name}, calibrated at load on the committed frames: "
            f"mean per-vertex displacement {budgets[name][0] * 100:.4f} % of "
            f"the bbox diagonal (max {budgets[name][1] * 100:.4f} %), {flips} "
            f"flipped flags of {2 * len(metas)} ({n_det} set in float) over "
            f"{len(metas)} frames against {prec} float"
            + (f" (budget < {INT8_BUDGET * 100:g} %, 0 flips)" if asserted
               else " (printed, not asserted)"))
        if asserted and (budgets[name][0] >= INT8_BUDGET or flips):
            raise AssertionError(f"{name} outside the int8 budget")
    say("int8", f"bf16+int8 image path launches {launches} "
        f"({time.perf_counter() - t0:.1f} s) [{card}]")
    return launches, budgets


def phase_precision_throughput(card, weights, frames_dir, out_dir):
    """The throughput path (folder mode, -t, use_pallas_mano "on", render
    512) at fp32 b8, bf16 b8 and bf16+int8 b16, in turns: run_folder with
    the launch counts zeroed just before and read just after, then the
    chunk step (CUDA events), its host syncs and folder-mode frames/s over
    warmed chunks."""
    import numpy as np
    from acr_tpu_torch.io.writers import collect_image_list
    from acr_tpu_torch.pipeline.app import ACRApp
    from acr_tpu_torch.utils.meters import StageTimer
    t0 = time.perf_counter()
    files = collect_image_list(frames_dir)
    runs = {}
    for prec, mode, bs in (("fp32", "none", CHUNK), ("bf16", "none", CHUNK),
                           ("bf16", "int8", CHUNK_INT8)):
        name = f"{prec}{'+' + mode if mode != 'none' else ''} b{bs}"
        d = os.path.join(out_dir, name.replace(" ", "_").replace("+", "_"))
        app = ACRApp(_throughput_cfg(frames_dir, d + "/", model_precision=prec,
                                     quantize=mode, val_batch_size=bs),
                     params=weights, device="cuda")
        _reset_launch_counts()
        results = app.run_folder()
        launches = {k: v for k, v in _launch_counts().items() if v}
        n_chunks = -(-N_THROUGHPUT // bs)
        if len(results) != N_THROUGHPUT or any(
                len(h) != 2 for h in results.values()):
            raise AssertionError(f"{name}: results")
        for key in ("verts", "j3d", "pj2d", "poses", "_rgba"):
            if not np.isfinite(app.last_output[key]).all():
                raise AssertionError(f"{name}: non-finite {key}")
        if (launches.get("mano_fused") != 4 * n_chunks
                or launches.get("raster_binned", 0) < N_THROUGHPUT):
            raise AssertionError(f"{name}: launches {launches}")
        image, offsets = _chunk_inputs(frames_dir, bs)
        step = lambda: app.chunk_step(image, offsets)
        t = cuda_ms(step, iters=3, reps=3, warmup=1)
        n_syncs, _ = count_syncs(step)
        app.timer = StageTimer()
        w0 = time.perf_counter()
        app._run_batched(files)
        fps = len(files) / (time.perf_counter() - w0)
        runs[name] = (t[0], t[0] / bs, fps, n_syncs, launches)
        say("precision_throughput", f"{name}: chunk step {ms_text(t)} "
            f"({t[0] / bs:.3f} ms per frame), {n_syncs} host syncs per step; "
            f"folder mode {fps:.3f} frames/s over {len(files)} warmed "
            f"{FRAME_HW[0]}x{FRAME_HW[1]} frames; run_folder launches "
            f"{launches} [{card}]")
        del app
    say("precision_throughput", f"({time.perf_counter() - t0:.1f} s)")
    return runs


def phase_aux(weights, out_dir):
    """One image-mode frame with show_items mesh, org_img, pj2d,
    centermap, j3d: every view written under JAX's _aux_path name."""
    import numpy as np
    from acr_tpu_torch.config import Config
    from acr_tpu_torch.pipeline.app import ACRApp
    if importlib.util.find_spec("cv2") is None:
        raise AssertionError("the aux views need cv2")
    cfg = Config(input_size=SIZE, render_size=SIZE, configs_yml="",
                 centermap_conf_thresh=-1e9, output_dir=out_dir,
                 show_items=("mesh",) + AUX_ITEMS)
    app = ACRApp(cfg, params=weights, device="cuda")
    frame = (np.random.RandomState(2).rand(*FRAME_HW, 3) * 255).astype(
        np.uint8)
    outs, launches = _image_run(app, [frame], "aux")
    _check_image_outs(outs, launches, "aux frame")
    written = sorted(os.listdir(out_dir))
    want = sorted(["aux_0.jpg"] + [f"aux_0_{i}.jpg" for i in AUX_ITEMS])
    maps = outs[0]["l_center_map"]
    say("aux", f"one {FRAME_HW[0]}x{FRAME_HW[1]} frame with show_items "
        f"{cfg.show_items}: wrote {written}; centre maps {maps.dtype} "
        f"{maps.shape}; launches {launches}")
    if written != want or maps.dtype != np.float32:
        raise AssertionError(f"aux files {written}, want {want}")
    return launches


# ---- data parallelism, the native host paths and the CLI's tools ----
DP = 2                        # replicas of the DP phases, both on cuda:0
CHUNK_DP = 16                 # val_batch_size there: 8 hands per replica side
# tests/test_parallel.py:98-102: the chunk's leaves against one replica
DP_ATOL = {"_rgba": 1.5 / 255, "cam_trans": 5e-3, "pj2d_org": 2e-3}
DP_TIMEOUT = 300              # seconds, each process of phase_dp_processes
# native render against B1 on the same outputs: the pixels whose coverage
# differs, at most this share of the covered pixels plus 20
# (tests/test_native.py:73, the JAX package's own bound)
NATIVE_COVER_SHARE = 0.02


def _dp_cfg(frames_dir, out_dir, **over):
    """Folder mode at val_batch_size 16, fused MANO on 'auto', render 512,
    the probe on every chunk."""
    kw = dict(val_batch_size=CHUNK_DP, use_pallas_mano="auto",
              temporal_optimization=False)
    kw.update(over)
    return _throughput_cfg(frames_dir, out_dir, **kw)


def _host_out(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


def _check_chunk(got, want, what):
    """Leaf for leaf at DP_ATOL (2e-4 where unnamed), the flags and the
    probe equal; returns the max abs errors."""
    import numpy as np
    if set(got) != set(want):
        raise AssertionError(f"{what}: keys {sorted(got)} vs {sorted(want)}")
    errs = {}
    for k in want:
        if want[k].dtype == bool or k == "_raster_overflow":
            if not np.array_equal(got[k], want[k]):
                raise AssertionError(f"{what}: {k} differs")
            continue
        errs[k] = float(np.abs(got[k] - want[k]).max())
        if errs[k] > DP_ATOL.get(k, 2e-4):
            raise AssertionError(f"{what}: {k} err {errs[k]}")
    return errs


def _dp_kernel_checks(app, out):
    """B4 and B1 on the card against their plain versions at the DP
    path's shapes: replica 1's MANO call (its 8 right hands, on its own
    kernel data) and its first frame's binned render. Launched after the
    path's counts were read."""
    import torch
    from acr_tpu_torch.ops import mano_kernel as mk
    from acr_tpu_torch.viz import raster as R
    from acr_tpu_torch.viz import raster_cuda as rc
    rep = app.pipeline.replicas[1]
    data = rep.mano_r.kernel
    half = slice(CHUNK_DP // DP, CHUNK_DP)
    poses = out["poses"][half, 1].to(rep.device)
    betas = out["betas"][half, 1].to(rep.device)
    coef, g_rows, _ = mk.blend_skin_operands(data, poses, betas)
    got = mk.fused_blend_skin(data, coef, g_rows)
    mano_err = float((got - mk.fused_blend_skin_plain(data, coef, g_rows))
                     .abs().max())
    if mano_err > 1e-5:
        raise AssertionError(f"dp: B4 against its plain version {mano_err}")
    k = half.start
    screen, faces, attrs = R.prepare_scene(
        out["verts"][k], out["cam_trans"][k], out["detection_flag"][k],
        app._replica_viz[rep.device].faces, SIZE, app.cfg.focal_length)
    tri, inv = rc.face_rows(screen, faces)
    args, table = binned_inputs(tri, inv, attrs, SIZE,
                                min(rc.BIN_CAP, faces.shape[0]))
    got = rc.raster_binned(*args, table=table)
    want = rc.raster_binned_plain(*args, table=table)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("dp: B1 differs from its plain version")
    return mano_err


def phase_dp(card, weights, frames_dir, out_dir):
    """Data parallelism on one card: folder mode at val_batch_size 16 on a
    2-replica mesh over devices [cuda:0, cuda:0]. run_folder over the 20
    frames (the launch counts zeroed just before, read just after: the
    "dp" path), then one chunk without -t and two with -t, each against
    the 1-replica chunk step on the same frames, and JAX's bypass
    reasons. No speedup is expected on one card: a correctness run."""
    import torch
    from acr_tpu_torch.pipeline.app import ACRApp
    t0 = time.perf_counter()
    devices = ["cuda:0"] * DP
    dp = ACRApp(_dp_cfg(frames_dir, os.path.join(out_dir, "folder") + "/",
                        data_parallel=DP), params=weights, devices=devices)
    if not dp._sharded_chunk or len(dp.pipeline.replicas) != DP:
        raise AssertionError(f"dp: not sharded ({dp._fused_bypass_reason})")
    _reset_launch_counts()
    results = dp.run_folder()
    launches = {k: v for k, v in _launch_counts().items() if v}
    n_chunks = -(-N_THROUGHPUT // CHUNK_DP)
    written = [o for o in os.listdir(dp.output_dir) if o.endswith(".jpg")]
    say("dp", f"run_folder over {N_THROUGHPUT} frames in {n_chunks} chunks "
        f"of {CHUNK_DP} on {DP} replicas {devices} (sharded forward and "
        f"render, no -t): {len(results)} results, {len(written)} frames "
        f"written; launches {launches}")
    if len(results) != N_THROUGHPUT or len(written) != N_THROUGHPUT or any(
            len(h) != 2 for h in results.values()):
        raise AssertionError("dp: run_folder results")
    # per chunk: a render per frame (the padded ones too), one fused MANO
    # launch per side and replica (8 hands each, PALLAS_MANO_MIN_BATCH)
    if launches != {"raster_binned": n_chunks * CHUNK_DP,
                    "mano_fused": n_chunks * 2 * DP}:
        raise AssertionError(f"dp: launches {launches}")

    image, offsets = _chunk_inputs(frames_dir, CHUNK_DP)
    one = ACRApp(_dp_cfg(frames_dir, None), params=weights, device="cuda")
    want = _host_out(one.chunk_step(image, offsets))
    got_t = dp.chunk_step(image, offsets)
    got = _host_out(got_t)
    errs = _check_chunk(got, want, "dp chunk without -t")
    mano_err = _dp_kernel_checks(dp, got_t)
    say("dp", f"one chunk of {CHUNK_DP} without -t on {DP} replicas against "
        f"one replica, max abs err {json.dumps(errs)} (tol {DP_ATOL}, else "
        f"2e-4); B4 on replica 1's 8 hands against its plain version "
        f"{mano_err:g}, B1 on its first frame bit for bit")

    tdp = ACRApp(_dp_cfg(frames_dir, None, data_parallel=DP,
                         temporal_optimization=True),
                 params=weights, devices=devices)
    tone = ACRApp(_dp_cfg(frames_dir, None, temporal_optimization=True),
                  params=weights, device="cuda")
    odd = ACRApp(_dp_cfg(frames_dir, None, data_parallel=DP,
                         val_batch_size=CHUNK_DP - 1),
                 params=weights, devices=devices)
    reasons = {"-t": tdp._fused_bypass_reason,
               "val_batch_size 15": odd._fused_bypass_reason}
    say("dp", f"per-stage reasons: {json.dumps(reasons)}")
    if (tdp._sharded_chunk or "OneEuro" not in reasons["-t"]
            or odd._sharded_chunk or "divide" not in reasons["val_batch_size 15"]):
        raise AssertionError(f"dp: bypass reasons {reasons}")
    for i in range(2):                      # the filter state carries over
        errs = _check_chunk(_host_out(tdp.chunk_step(image, offsets)),
                            _host_out(tone.chunk_step(image, offsets)),
                            f"dp chunk {i} with -t")
        say("dp", f"chunk {i} with -t (sharded forward; OneEuro, refine and "
            f"render on the lead replica) against one replica: max abs err "
            f"{json.dumps(errs)}")
    state_err = max(float((a - b).abs().max()) for a, b in zip(
        _state_leaves(tdp.filter_state), _state_leaves(tone.filter_state)))
    if state_err > 2e-4:
        raise AssertionError(f"dp: OneEuro state err {state_err}")

    t_one = cuda_ms(lambda: one.chunk_step(image, offsets), iters=3, reps=3,
                    warmup=1)
    t_dp = cuda_ms(lambda: dp.chunk_step(image, offsets), iters=3, reps=3,
                   warmup=1)
    say("dp", f"b{CHUNK_DP} chunk step without -t (forward + {CHUNK_DP} "
        f"renders): 1 replica {ms_text(t_one)}; {DP} replicas on one card "
        f"{ms_text(t_dp)} [{card}] ({time.perf_counter() - t0:.1f} s)")
    del dp, one, tdp, tone, odd
    torch.cuda.empty_cache()
    return launches, want, {"one": t_one[0], "dp": t_dp[0]}


def dp_worker(rank, port, frames_dir, out_path):
    """One process of phase_dp_processes: a 2-process mesh of one replica
    each (cuda:0), one chunk of 16 frames; saves the gathered chunk."""
    import numpy as np
    import torch
    from acr_tpu_torch.pipeline.app import ACRApp
    cfg = _dp_cfg(frames_dir, None, data_parallel=DP,
                  coordinator=f"localhost:{port}", num_processes=DP,
                  process_id=rank)
    app = ACRApp(cfg, params=_weights(CAM_SCALE["near"]), device="cuda")
    mesh = app.pipeline.mesh
    if (mesh.rank, mesh.size, len(mesh.devices)) != (rank, DP, 1) or not \
            app._sharded_chunk:
        raise AssertionError(f"rank {rank}: mesh {mesh}")
    image, offsets = _chunk_inputs(frames_dir, CHUNK_DP)
    _reset_launch_counts()
    out = _host_out(app.chunk_step(image, offsets))
    launches = {k: v for k, v in _launch_counts().items() if v}
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        _host_out(app.chunk_step(image, offsets))
        walls.append((time.perf_counter() - t0) * 1e3)
    np.savez(out_path, **out)
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: OK; launches {json.dumps(launches)}; chunk step "
          f"with the gather and readback, host wall {sorted(walls)} ms",
          flush=True)


def phase_dp_processes(card, frames_dir, want, out_dir):
    """Two fresh interpreters join through init_distributed (gloo) at an
    ephemeral localhost port, each owns one replica on cuda:0 and runs one
    chunk of 16 frames at 512 px; every rank must hold the whole gathered
    chunk, equal to the 1-process chunk at DP_ATOL. Each process has its
    own time limit."""
    import socket
    import numpy as np
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, ACR_INIT_TIMEOUT=str(DP_TIMEOUT))
    env.pop("ACR_COORDINATOR", None)
    outs = [os.path.join(out_dir, f"rank{r}.npz") for r in range(DP)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--dp-worker",
         str(r), str(port), frames_dir, outs[r]], cwd=out_dir, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(DP)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DP_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        line = [x for x in log.splitlines() if x.startswith(f"rank {r}:")]
        if p.returncode != 0 or not line:
            raise AssertionError(f"rank {r} failed ({p.returncode}):\n"
                                 f"{log[-3000:]}")
        say("dp_processes", f"{line[-1]} [{card}]")
    for r in range(DP):
        with np.load(outs[r]) as got:
            errs = _check_chunk({k: got[k] for k in got.files}, want,
                                f"rank {r}'s gathered chunk")
        say("dp_processes", f"rank {r} holds the whole chunk of {CHUNK_DP}: "
            f"against one process, max abs err {json.dumps(errs)}")
    say("dp_processes", f"({time.perf_counter() - t0:.1f} s)")


def phase_native(card, apps, frames, weights, frames_dir, out_dir):
    """The native host paths on the card: the main path's 3 image-mode
    frames with renderer='native' and jit_translation_solve=False against
    the same app on the CPU; the native render against B1's on the same
    outputs; then one folder chunk at b8 (per-stage: the chunk step
    without its render, the host solve, the host render per frame)
    against the CPU's chunk step and host solve. Host ms per frame of
    both beside render_hands'."""
    import logging
    import numpy as np
    import torch
    from acr_tpu_torch.config import Config
    from acr_tpu_torch.pipeline.app import ACRApp
    t0 = time.perf_counter()
    cfg = Config(input_size=SIZE, render_size=SIZE, configs_yml="",
                 centermap_conf_thresh=-1e9, renderer="native",
                 jit_translation_solve=False,
                 output_dir=os.path.join(out_dir, "image") + "/")
    gpu = ACRApp(cfg, params=weights, device="cuda")
    cpu = ACRApp(dataclasses.replace(
        cfg, output_dir=os.path.join(out_dir, "image_cpu") + "/"),
        params=weights, device="cpu")
    _reset_launch_counts()
    outs = []
    for i, frame in enumerate(frames):
        gpu.process_frame(frame, f"native_{i}.jpg")
        outs.append(gpu.last_output)
    launches = {k: v for k, v in _launch_counts().items() if v}
    if launches or any("_rgba" in o for o in outs):
        raise AssertionError(f"native: a device render ran: {launches}")
    errs = {"verts": 0.0, "cam_trans": 0.0, "rgba": 0.0}
    cover = []
    for i, frame in enumerate(frames):
        cpu.process_frame(frame, f"native_{i}.jpg")
        g, c = outs[i], cpu.last_output
        for k in ("verts", "cam_trans"):
            errs[k] = max(errs[k], float(np.abs(g[k] - c[k]).max()))
        rgba_g = gpu.visualizer.render_rgba(g)
        rgba_c = cpu.visualizer.render_rgba(c)
        errs["rgba"] = max(errs["rgba"], float(np.abs(rgba_g - rgba_c).max()))
        b1 = apps["near"].visualizer.render_rgba(g)      # B1, read back
        native_cov, b1_cov = rgba_g[..., 3] > 0, b1[..., 3] > 0
        differ = int((native_cov != b1_cov).sum())
        cover.append((differ, int(b1_cov.sum())))
        if not native_cov.any() or differ > NATIVE_COVER_SHARE * b1_cov.sum() + 20:
            raise AssertionError(f"native frame {i}: coverage differs from "
                                 f"B1's at {differ} of {b1_cov.sum()} px")
    written = sorted(os.listdir(gpu.output_dir))
    say("native", f"{len(frames)} image-mode frames, renderer native + host "
        f"solve: card vs CPU max abs err {json.dumps(errs)} (tol 1e-4 on "
        f"verts and the solved cam_trans); coverage against B1's render of "
        f"the same outputs differs at {[d for d, _ in cover]} of "
        f"{[n for _, n in cover]} covered px "
        f"({sum(d for d, _ in cover) / max(1, sum(n for _, n in cover)):.4f}); "
        f"written {written}; launches {launches}")
    if errs["verts"] > 1e-4 or errs["cam_trans"] > 1e-4 or len(written) != len(frames):
        raise AssertionError("native: card and CPU disagree")

    # host ms per frame: the native render and the host solve, beside
    # render_hands on the card
    g = outs[0]
    n = 10
    w0 = time.perf_counter()
    for _ in range(n):
        gpu.visualizer.render_rgba(g)
    render_ms = (time.perf_counter() - w0) / n * 1e3
    w0 = time.perf_counter()
    for _ in range(n):
        gpu._host_translation(dict(g))
    solve_ms = (time.perf_counter() - w0) / n * 1e3
    dev_out = {k: torch.as_tensor(g[k]).cuda()
               for k in ("verts", "cam_trans", "detection_flag")}
    rh = cuda_ms(lambda: apps["near"].visualizer.render_rgba_device(dev_out),
                 iters=20)
    say("native", f"host ms per frame ({n} calls, host clock): native render "
        f"at {SIZE} px {render_ms:.3f} ms, host RANSAC solve (2 hands) "
        f"{solve_ms:.3f} ms; render_hands on the card {ms_text(rh)} [{card}]")

    # one folder chunk at b8 with both host paths
    chunk_dir = os.path.join(out_dir, "chunk_frames")
    os.makedirs(chunk_dir, exist_ok=True)
    names = sorted(os.listdir(frames_dir))[:CHUNK]
    for name in names:
        dst = os.path.join(chunk_dir, name)
        if not os.path.exists(dst):
            os.symlink(os.path.join(frames_dir, name), dst)
    fcfg = _throughput_cfg(chunk_dir, os.path.join(out_dir, "folder") + "/",
                           renderer="native", jit_translation_solve=False)
    app = ACRApp(fcfg, params=weights, device="cuda")
    caught = []
    handler = logging.Handler()
    handler.emit = lambda record: caught.append(record.getMessage())
    logger = logging.getLogger("acr_tpu_torch")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    _reset_launch_counts()
    try:
        w0 = time.perf_counter()
        results = app.run_folder()
        wall = time.perf_counter() - w0
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    launches = {k: v for k, v in _launch_counts().items() if v}
    bypass = [m for m in caught if "bypassed" in m]
    written = [o for o in os.listdir(app.output_dir) if o.endswith(".jpg")]
    image, offsets = _chunk_inputs(chunk_dir, CHUNK)
    cpu_app = ACRApp(dataclasses.replace(fcfg, renderer="none"),
                     params=weights, device="cpu")
    want = _host_out(cpu_app.chunk_step(image, offsets))
    cpu_app._host_translation(want)
    got = app.last_output
    err = {k: float(np.abs(got[k] - want[k]).max())
           for k in ("verts", "cam_trans")}
    say("native", f"folder mode, one chunk of {CHUNK} ({FRAME_HW[0]}x"
        f"{FRAME_HW[1]}, -t, native render + host solve) in {wall:.2f} s: "
        f"{len(results)} results, {len(written)} frames written; logged "
        f"{bypass}; launches {launches}; against the CPU's chunk step and "
        f"host solve, max abs err {json.dumps(err)} (tol 1e-4)")
    if (len(results) != CHUNK or len(written) != CHUNK or "_rgba" in got
            or not bypass or "host translation solve" not in bypass[0]
            or launches.get("raster_binned") or max(err.values()) > 1e-4):
        raise AssertionError("native: the folder chunk")
    say("native", f"({time.perf_counter() - t0:.1f} s)")
    return {"render_ms": render_ms, "solve_ms": solve_ms, "render_hands_ms": rh[0]}


def _write_flax_npz(params, path):
    """A state dict as the npz of flax paths that load_params reads (the
    inverse of io.params.from_flax for the float network)."""
    import numpy as np
    flat = {}
    for key, v in params.items():
        parts, a = key.split("."), v.numpy()
        if parts[-1] == "weight":
            parts[-1] = "kernel"
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        flat["/".join(parts)] = a
    np.savez(path, **flat)


def phase_cli(card, weights, frames_dir, out_dir):
    """``python -m acr_tpu_torch.cli`` in image mode on the card with
    --profile_dir: the config session's YAML exists under active_configs/
    while the run lasts and is gone after it, and the trace is a device
    trace (it names raster_binned_kernel)."""
    import torch
    from acr_tpu_torch.io.params import load_params
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    npz = os.path.join(out_dir, "weights.npz")
    _write_flax_npz(weights, npz)
    loaded, _ = load_params(npz)
    if not all(torch.equal(loaded[k], weights[k]) for k in weights):
        raise AssertionError("cli: the flax-path npz does not round-trip")
    prof = os.path.join(out_dir, "profile")
    active = os.path.join(out_dir, "active_configs")
    image = os.path.join(frames_dir, sorted(os.listdir(frames_dir))[0])
    cmd = [sys.executable, "-m", "acr_tpu_torch.cli", "--demo_mode", "image",
           "--inputs", image, "--model_path", npz, "--configs_yml", "",
           "--centermap_conf_thresh=-1e9", "--profile_dir", prof,
           "--output_dir", os.path.join(out_dir, "out") + "/"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(cmd, cwd=out_dir, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    seen = set()
    deadline = time.perf_counter() + DP_TIMEOUT
    while proc.poll() is None and time.perf_counter() < deadline:
        if os.path.isdir(active):
            seen.update(os.listdir(active))
        time.sleep(0.05)
    if proc.poll() is None:
        proc.kill()
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise AssertionError(f"cli failed ({proc.returncode}):\n{log[-3000:]}")
    left = os.listdir(active) if os.path.isdir(active) else []
    traces = os.listdir(prof) if os.path.isdir(prof) else []
    names_kernel = False
    if len(traces) == 1:
        with open(os.path.join(prof, traces[0])) as f:
            names_kernel = "raster_binned_kernel" in f.read()
    written = os.listdir(os.path.join(out_dir, "out"))
    say("cli", f"{' '.join(cmd[1:4])} ... --profile_dir: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s; session YAML seen during the run "
        f"{sorted(seen)}, left after it {left}; trace {traces} names "
        f"raster_binned_kernel: {names_kernel}; written {written} [{card}]")
    if (len(seen) != 1 or not next(iter(seen)).endswith(".yaml") or left
            or not names_kernel or written != [os.path.basename(image)]):
        raise AssertionError("cli: session, trace or output")


def main():
    if not os.path.isdir(os.path.join(ROOT, "acr_tpu_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         "repository (acr_tpu_torch/ not found beside it)")
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: torch.cuda.is_available() is False")
    if sys.argv[1:2] == ["--dp-worker"]:     # one rank of phase_dp_processes
        rank, port, frames_dir, out_path = sys.argv[2:6]
        return dp_worker(int(rank), int(port), frames_dir, out_path)
    card, _ = phase_env()
    phase_build()
    kin = phase_kernels()
    banded_err, serpentine_flat_err = phase_kernels_banded()
    mano_err = phase_kernels_mano()
    out_dir = os.path.join(ROOT, "build", "chip_smoke_out")
    launches, apps, frames = phase_main(out_dir)
    flat_hi = phase_band_overflow(card, os.path.join(out_dir, "band"))
    weights = _weights(CAM_SCALE["near"])
    stream_launches = phase_stream(weights, os.path.join(out_dir, "stream"))
    phase_device_vs_cpu(apps, frames)
    phase_device_vs_cpu_t(weights, os.path.join(out_dir, "t"))
    times, errs, bounds, device, b1 = phase_times(card, apps, frames)
    device["raster_flat"], bounds["raster_flat"] = (flat_hi["device_ms"],
                                                    flat_hi["bound"])
    stimes, stream_err, bounds["raster_banded"], device["raster_banded"] = \
        phase_times_stream(card, weights, os.path.join(out_dir, "times"))
    frames_dir = os.path.join(out_dir, "throughput_frames")
    t_launches, t_app = phase_throughput(
        weights, frames_dir, os.path.join(out_dir, "throughput") + "/")
    phase_device_vs_cpu_chunk(weights, frames_dir,
                              os.path.join(out_dir, "chunk") + "/")
    ttimes, tdevice = phase_times_throughput(card, weights, frames_dir, t_app)
    t_new = time.perf_counter()
    phase_int8_conv(card)
    bf16_launches, _ = phase_bf16(card, apps, frames,
                                  os.path.join(out_dir, "bf16"))
    int8_launches, _ = phase_int8(card, frames, os.path.join(out_dir, "int8"))
    p_runs = phase_precision_throughput(card, weights, frames_dir,
                                        os.path.join(out_dir, "precision"))
    aux_launches = phase_aux(weights, os.path.join(out_dir, "aux"))
    say("precision", f"the bf16, int8 and aux phases took "
        f"{time.perf_counter() - t_new:.1f} s")
    t_new = time.perf_counter()
    dp_launches, dp_want, _ = phase_dp(card, weights, frames_dir,
                                       os.path.join(out_dir, "dp"))
    phase_dp_processes(card, frames_dir, dp_want,
                       os.path.join(out_dir, "dp_processes"))
    phase_native(card, apps, frames, weights, frames_dir,
                 os.path.join(out_dir, "native"))
    phase_cli(card, weights, frames_dir, os.path.join(out_dir, "cli"))
    say("dp", f"the dp, native and cli phases took "
        f"{time.perf_counter() - t_new:.1f} s")
    device["mano_fused"] = tdevice[f"mano_fused_{CHUNK}"]
    # B4 at the throughput path's shape: 8 hands per launch
    bounds["mano_fused"] = mano_bound(CHUNK)
    src = "acr_tpu_torch/csrc/raster.cu"
    # ms: back-to-back calls by CUDA events (the host's issue included
    # where it is slower than the device); device_ms: launches captured in
    # one CUDA graph and replayed. raster_flat's numbers are its path's: the
    # app's band-overflow frame at 2048 px (its 512 px far-frame times, beside
    # B1's, are printed above); raster_binned's the near frame, with the
    # far frame and the overflow scene under "scenes"
    entry = lambda name, replaces, source, n, err, ms, plain_ms, lib_ms: {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": n, "max_abs_err": err, "ms": ms,
        "device_ms": device[name], "plain_ms": plain_ms,
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        "library_ms": lib_ms}
    mano = entry("mano_fused", "acr_tpu/ops/mano_kernel.py:88",
                 "acr_tpu_torch/csrc/mano.cu", t_launches["mano_fused"],
                 mano_err, ttimes[f"mano_fused_{CHUNK}"],
                 ttimes[f"mano_fused_plain_{CHUNK}"],
                 ttimes[f"mano_library_{CHUNK}"])
    mano["library_device_ms"] = tdevice[f"mano_library_{CHUNK}"]
    binned = entry("raster_binned", "acr_tpu/viz/raster_pallas.py:193", src,
                   launches["raster_binned"],
                   max(kin["binned_err"], errs["raster_binned"]),
                   times["raster_binned"], times["raster_binned_plain"], None)
    # the launches on the bf16, int8 and aux paths, each counted from 0
    binned["paths"] = {
        "bf16 image b1": bf16_launches["raster_binned"],
        "bf16+int8 image b1": int8_launches["raster_binned"],
        "aux views image b1": aux_launches["raster_binned"],
        **{f"folder {k}": v[4]["raster_binned"] for k, v in p_runs.items()}}
    mano["paths"] = {f"folder {k}": v[4]["mano_fused"]
                     for k, v in p_runs.items()}
    # folder mode at b16 on 2 replicas of one card, counted from 0
    binned["paths"]["dp"] = dp_launches["raster_binned"]
    mano["paths"]["dp"] = dp_launches["mano_fused"]
    binned["scenes"] = {
        name: {"ms": r["ms"][0], "device_ms": r["device_ms"],
               "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
               "max_faces_per_tile": r["max"], "tiles_over_cap": r["over"],
               "folded_pairs": r["pairs"], "flat_device_ms": r["flat_device_ms"]}
        for name, r in b1.items()}
    print(json.dumps({"kernels": [
        entry("raster_flat", "acr_tpu/viz/raster_pallas.py:106", src,
              flat_hi["launches"],
              max(kin["flat_err"], serpentine_flat_err, flat_hi["err"]),
              flat_hi["ms"], flat_hi["plain_ms"], None),
        binned,
        entry("raster_banded", "acr_tpu/viz/raster_pallas.py:298", src,
              stream_launches["raster_banded"], max(banded_err, stream_err),
              stimes["raster_banded"], stimes["raster_banded_plain"], None),
        mano,
    ]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
