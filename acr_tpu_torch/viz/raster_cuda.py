"""The rasterizer's CUDA kernels, their plain PyTorch versions, and the prestage.

Counterpart of ``acr_tpu/viz/raster_pallas.py`` for the 512 px path:

* ``raster_flat`` launches ``raster_flat_kernel`` (``csrc/raster.cu``),
  the port of the Pallas ``_raster_kernel``: every face over every
  pixel, the exact path for any frame;
* ``raster_binned`` launches ``raster_binned_kernel``, the port of
  ``_raster_kernel_binned``: the same math over each 8 x ``col_tile``
  pixel tile's bbox-binned face list, bounded by the tile's live count;
* ``bin_faces`` is the prestage (``_bin_faces``): a STABLE argsort of
  the tile x face overlap keeps every tile's list in ascending face id,
  so the lowest-id tie rule holds and the binned kernel is bit-identical
  to the flat one while no tile exceeds ``cap``; above ``cap`` the
  highest ids drop. ``bin_overflow_stats`` is the tier gate.

Each wrapper runs its plain PyTorch version for tensors on the CPU and
launches its kernel for CUDA tensors, or raises; it never falls back.
The plain versions compute the edge math with the same operations in
the same order, one rounding per operation, so on the card a kernel and
its plain version agree bit for bit. ``LAUNCHES`` counts kernel launches.

The kernels are built at first use with ``nvcc`` into a shared library
with a plain C interface, loaded with ctypes, under
``build/torch_ext/<hash of the sources and flags>/`` in the checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional, Tuple

import torch

ROW_TILE = 8
FACE_CHUNK = 128      # faces padded to a multiple; plain versions fold chunks
COL_TILE = 256
BIN_CAP = 512
N_ATTR = 16
TIERS = (128, 256, 512)

# kernel launches since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {"raster_flat": 0, "raster_binned": 0}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
SOURCES = (os.path.join(_PKG, "csrc", "raster.cu"),)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
_LIB_NAME = "libacr_raster.so"
_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc): cannot build "
                           "the rasterizer kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_extension() -> Tuple[str, str]:
    """Compile ``csrc/raster.cu`` if this exact source has no build yet.

    Returns (path of the shared library, the compiler's log, which holds
    ptxas' register and spill report; empty when the build existed)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(_REPO, "build", "torch_ext", h.hexdigest()[:16])
    so = os.path.join(out_dir, _LIB_NAME)
    if os.path.exists(so):
        return so, ""
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(log)
    os.replace(tmp, so)
    return so, log


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            so, _ = build_extension()
            lib = ctypes.CDLL(so)
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.acr_raster_flat.argtypes = [p, p, p, i, i, i, p, p, p, p, p]
            lib.acr_raster_flat.restype = i
            lib.acr_raster_binned.argtypes = [p, p, p, p, i, i, i, i,
                                              p, p, p, p, p]
            lib.acr_raster_binned.restype = i
            _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _outputs(height: int, width: int, device):
    return (torch.empty((height, width), dtype=torch.int32, device=device),
            torch.empty((height, width), dtype=torch.float32, device=device),
            torch.empty((height, width), dtype=torch.float32, device=device),
            torch.empty((N_ATTR, height, width), dtype=torch.float32,
                        device=device))


def _launch(fn, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# the edge math shared by both plain versions (op order of the kernels)
# ---------------------------------------------------------------------------

def _edge_fold(gx, gy, rows, inv, s0, s1):
    """Barycentrics, inside test and depth of face slots [s0, s1) at the
    pixel centres (gx, gy); ``rows`` (..., 9+, n) triangle rows with the
    face axis last, ``inv`` (..., n). Returns (w0, w1, depth with inf
    outside), broadcast over pixels."""
    r = lambda k: rows[..., k, None, s0:s1]
    ax, ay, az, bx, by, bz, cx, cy, cz = (r(k) for k in range(9))
    iv = inv[..., None, s0:s1]
    w0 = ((cx - bx) * (gy - by) - (cy - by) * (gx - bx)) * iv
    w1 = ((ax - cx) * (gy - cy) - (ay - cy) * (gx - cx)) * iv
    w2 = 1.0 - w0 - w1
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (iv != 0.0)
    depth = w0 * az + w1 * bz + w2 * cz
    depth = torch.where(inside, depth, torch.full_like(depth, float("inf")))
    return w0, w1, depth


def _fold_step(carry, w0, w1, depth, first):
    """Lowest-index argmin inside the chunk, strict `<` against the
    running buffers: the winner is the lowest slot among equal depths."""
    zbuf, slot, b0, b1 = carry
    best = torch.argmin(depth, dim=-1, keepdim=True)
    best_z = depth.gather(-1, best)[..., 0]
    win = best_z < zbuf
    return (torch.where(win, best_z, zbuf),
            torch.where(win, best[..., 0].to(torch.int32) + first, slot),
            torch.where(win, w0.gather(-1, best)[..., 0], b0),
            torch.where(win, w1.gather(-1, best)[..., 0], b1))


def _pixel_budget(n_px_per_row: int) -> int:
    """Rows (or tiles) per plain-version step: bounds each (rows, px,
    FACE_CHUNK) intermediate to 4M floats."""
    return max(1, (1 << 22) // (n_px_per_row * FACE_CHUNK))


# ---------------------------------------------------------------------------
# flat kernel (B2)
# ---------------------------------------------------------------------------

def raster_flat_plain(tri: torch.Tensor, inv: torch.Tensor,
                      attrs: Optional[torch.Tensor], height: int, width: int):
    """Plain PyTorch version of ``raster_flat`` (any device).

    tri (9, F) rows [ax ay az bx by bz cx cy cz], inv (F,) inverse signed
    areas (0 for degenerate faces), attrs (16, F) or None. Returns fid
    (H, W) int32 (-1 background), b0, b1 (H, W) f32 and the winner's
    attribute planes (16, H, W) (None without attrs), zeros on background.
    """
    dev = inv.device
    n_faces = inv.shape[0]
    gx = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[:, None]
    step = _pixel_budget(width)
    fids, b0s, b1s = [], [], []
    for y0 in range(0, height, step):
        y1 = min(y0 + step, height)
        gy = (torch.arange(y0, y1, dtype=torch.float32, device=dev)
              + 0.5)[:, None, None]
        shape = (y1 - y0, width)
        carry = (torch.full(shape, float("inf"), device=dev),
                 torch.full(shape, -1, dtype=torch.int32, device=dev),
                 torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
        for s0 in range(0, n_faces, FACE_CHUNK):
            s1 = min(s0 + FACE_CHUNK, n_faces)
            w0, w1, depth = _edge_fold(gx, gy, tri, inv, s0, s1)
            carry = _fold_step(carry, w0, w1, depth, s0)
        fids.append(carry[1])
        b0s.append(carry[2])
        b1s.append(carry[3])
    fid = torch.cat(fids)
    attr_planes = None
    if attrs is not None:
        picked = attrs[:, fid.clamp(min=0).long()]
        attr_planes = torch.where(fid >= 0, picked, torch.zeros_like(picked))
    return fid, torch.cat(b0s), torch.cat(b1s), attr_planes


def raster_flat(tri: torch.Tensor, inv: torch.Tensor, attrs: torch.Tensor,
                height: int, width: int):
    """Flat z-buffer raster: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Same arguments and outputs as
    ``raster_flat_plain`` (attrs required)."""
    if inv.device.type == "cpu":
        return raster_flat_plain(tri, inv, attrs, height, width)
    if inv.device.type != "cuda":
        raise ValueError(f"raster_flat: unsupported device {inv.device}")
    n_faces = inv.shape[0]
    dev = inv.device
    _check("tri", tri, torch.float32, (9, n_faces), dev)
    _check("inv", inv, torch.float32, (n_faces,), dev)
    _check("attrs", attrs, torch.float32, (N_ATTR, n_faces), dev)
    fid, b0, b1, attr_planes = _outputs(height, width, dev)
    lib = _library()
    _launch(lib.acr_raster_flat, dev, tri.data_ptr(), inv.data_ptr(),
            attrs.data_ptr(), n_faces, height, width, fid.data_ptr(),
            b0.data_ptr(), b1.data_ptr(), attr_planes.data_ptr())
    LAUNCHES["raster_flat"] += 1
    return fid, b0, b1, attr_planes


# ---------------------------------------------------------------------------
# binned kernel (B1) and its prestage
# ---------------------------------------------------------------------------

def _tile_overlap(tri_rows: torch.Tensor, inv_area: torch.Tensor,
                  height: int, width: int, col_tile: int) -> torch.Tensor:
    """(T, F) bool: live face f's bbox reaches tile t (8 x ``col_tile``
    pixels, row-major grid order). tri_rows (R, F), rows 0..8 the
    triangle; a face is live where ``inv_area != 0``."""
    dev = tri_rows.device
    n_ty, n_tx = height // ROW_TILE, width // col_tile
    xs, ys = tri_rows[[0, 3, 6]], tri_rows[[1, 4, 7]]
    xmin, xmax = xs.min(0).values, xs.max(0).values
    ymin, ymax = ys.min(0).values, ys.max(0).values
    ty = torch.arange(n_ty, dtype=torch.float32, device=dev) * ROW_TILE
    tx = torch.arange(n_tx, dtype=torch.float32, device=dev) * col_tile
    # pixel centers in a tile span [t0 + 0.5, t0 + tile - 0.5]
    y_hit = (ymin[None] <= ty[:, None] + ROW_TILE) & (ymax[None] >= ty[:, None])
    x_hit = (xmin[None] <= tx[:, None] + col_tile) & (xmax[None] >= tx[:, None])
    live = inv_area != 0.0
    return (y_hit[:, None, :] & x_hit[None, :, :]
            & live[None, None, :]).reshape(n_ty * n_tx, -1)


def bin_faces(tri_rows: torch.Tensor, inv_area: torch.Tensor, height: int,
              width: int, col_tile: int, cap: int):
    """Bin faces into fixed-capacity per-tile lists by bbox overlap.

    tri_rows (R, F) with rows 0..8 the triangle, inv_area (F,) ->
    tri_t (T, R, cap), inv_t (T, cap), ids_t (T, cap) int32 global ids
    (-1 for empty slots) and counts (T,) int32 live slots, clipped to
    ``cap``; T = (H/8) * (W/col_tile) tiles in row-major grid order.
    The stable argsort keeps each tile's faces in ascending id order; a
    tile above ``cap`` drops its highest ids.
    """
    dev = tri_rows.device
    overlap = _tile_overlap(tri_rows, inv_area, height, width, col_tile)
    order = torch.argsort((~overlap).to(torch.uint8), dim=1,
                          stable=True)[:, :cap]                  # (T, cap)
    counts = overlap.sum(dim=1).clamp(max=cap).to(torch.int32)
    slot_live = (torch.arange(cap, device=dev)[None, :] < counts[:, None])
    tri_t = tri_rows.T[order].transpose(1, 2).contiguous()     # (T, R, cap)
    inv_t = torch.where(slot_live, inv_area[order],
                        torch.zeros((), device=dev))
    ids_t = torch.where(slot_live, order.to(torch.int32),
                        torch.full((), -1, dtype=torch.int32, device=dev))
    return tri_t, inv_t.contiguous(), ids_t.contiguous(), counts


def _tiles_to_planes(t: torch.Tensor, height: int, width: int,
                     col_tile: int) -> torch.Tensor:
    """(T, ..., 8 * col_tile) tile-major -> (..., H, W)."""
    n_ty, n_tx = height // ROW_TILE, width // col_tile
    lead = t.shape[1:-1]
    t = t.reshape((n_ty, n_tx) + lead + (ROW_TILE, col_tile))
    k = len(lead)
    perm = tuple(range(2, 2 + k)) + (0, 2 + k, 1, 3 + k)
    return t.permute(perm).reshape(lead + (height, width))


def raster_binned_plain(counts: torch.Tensor, tri_t: torch.Tensor,
                        inv_t: torch.Tensor, ids_t: torch.Tensor,
                        height: int, width: int, col_tile: int):
    """Plain PyTorch version of ``raster_binned`` (any device).

    counts (T,) int32, tri_t (T, 32, cap) (rows 0..8 triangle, 16..31
    attribute rows), inv_t (T, cap), ids_t (T, cap) int32, as
    ``bin_faces`` makes them. It folds every slot (the kernel stops at
    the tile's count; slots past it have inv = 0 and never win). Same
    outputs as ``raster_flat_plain``.
    """
    del counts
    dev = inv_t.device
    n_tiles, _, cap = tri_t.shape
    n_tx = width // col_tile
    px = ROW_TILE * col_tile
    lin = torch.arange(px, device=dev)
    loc_x = (lin % col_tile).to(torch.float32)
    loc_y = torch.div(lin, col_tile, rounding_mode="floor").to(torch.float32)
    tiles = torch.arange(n_tiles, device=dev)
    org_x = ((tiles % n_tx) * col_tile).to(torch.float32)
    org_y = (torch.div(tiles, n_tx, rounding_mode="floor")
             * ROW_TILE).to(torch.float32)
    gx_all = (org_x[:, None] + loc_x[None]) + 0.5              # (T, px)
    gy_all = (org_y[:, None] + loc_y[None]) + 0.5
    step = _pixel_budget(px)
    fids, b0s, b1s, slots = [], [], [], []
    for t0 in range(0, n_tiles, step):
        t1 = min(t0 + step, n_tiles)
        gx, gy = gx_all[t0:t1, :, None], gy_all[t0:t1, :, None]
        rows, inv = tri_t[t0:t1], inv_t[t0:t1]
        shape = (t1 - t0, px)
        carry = (torch.full(shape, float("inf"), device=dev),
                 torch.full(shape, -1, dtype=torch.int32, device=dev),
                 torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
        for s0 in range(0, cap, FACE_CHUNK):
            s1 = min(s0 + FACE_CHUNK, cap)
            w0, w1, depth = _edge_fold(gx, gy, rows, inv, s0, s1)
            carry = _fold_step(carry, w0, w1, depth, s0)
        slot = carry[1]
        gid = ids_t[t0:t1].gather(1, slot.clamp(min=0).long())
        fids.append(torch.where(slot >= 0, gid, torch.full_like(gid, -1)))
        b0s.append(carry[2])
        b1s.append(carry[3])
        slots.append(slot)
    slot = torch.cat(slots)                                     # (T, px)
    idx = slot.clamp(min=0).long()[:, None, :].expand(-1, N_ATTR, -1)
    picked = tri_t[:, 16:16 + N_ATTR].gather(2, idx)            # (T, 16, px)
    picked = torch.where((slot >= 0)[:, None, :], picked,
                         torch.zeros_like(picked))
    plane = lambda t: _tiles_to_planes(t, height, width, col_tile)
    return (plane(torch.cat(fids)), plane(torch.cat(b0s)),
            plane(torch.cat(b1s)), plane(picked))


def raster_binned(counts: torch.Tensor, tri_t: torch.Tensor,
                  inv_t: torch.Tensor, ids_t: torch.Tensor, height: int,
                  width: int, col_tile: int):
    """Binned z-buffer raster: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Same arguments and outputs as
    ``raster_binned_plain``."""
    if inv_t.device.type == "cpu":
        return raster_binned_plain(counts, tri_t, inv_t, ids_t, height,
                                   width, col_tile)
    if inv_t.device.type != "cuda":
        raise ValueError(f"raster_binned: unsupported device {inv_t.device}")
    dev = inv_t.device
    n_tiles, cap = inv_t.shape
    if (height % ROW_TILE or width % col_tile
            or n_tiles != (height // ROW_TILE) * (width // col_tile)):
        raise ValueError(f"raster_binned: {n_tiles} tiles do not tile "
                         f"{height}x{width} at 8x{col_tile}")
    _check("counts", counts, torch.int32, (n_tiles,), dev)
    _check("tri_t", tri_t, torch.float32, (n_tiles, 32, cap), dev)
    _check("inv_t", inv_t, torch.float32, (n_tiles, cap), dev)
    _check("ids_t", ids_t, torch.int32, (n_tiles, cap), dev)
    fid, b0, b1, attr_planes = _outputs(height, width, dev)
    lib = _library()
    _launch(lib.acr_raster_binned, dev, counts.data_ptr(), tri_t.data_ptr(),
            inv_t.data_ptr(), ids_t.data_ptr(), cap, height, width, col_tile,
            fid.data_ptr(), b0.data_ptr(), b1.data_ptr(),
            attr_planes.data_ptr())
    LAUNCHES["raster_binned"] += 1
    return fid, b0, b1, attr_planes


# ---------------------------------------------------------------------------
# launchers: the counterparts of rasterize_pallas / rasterize_pallas_binned
# ---------------------------------------------------------------------------

def face_rows(verts_screen: torch.Tensor, faces: torch.Tensor):
    """(V, 3) screen verts, (F, 3) faces -> triangle rows (9, F)
    [ax ay az bx by bz cx cy cz] and inverse signed areas (F,), 0 where
    |area| < 1e-9."""
    tri = verts_screen[faces.long()]                           # (F, 3, 3)
    rows = tri.permute(1, 2, 0).reshape(9, -1).contiguous()
    xs, ys = tri[:, :, 0], tri[:, :, 1]
    area = ((xs[:, 1] - xs[:, 0]) * (ys[:, 2] - ys[:, 0])
            - (xs[:, 2] - xs[:, 0]) * (ys[:, 1] - ys[:, 0]))
    inv = torch.where(area.abs() < 1e-9, torch.zeros_like(area), 1.0 / area)
    return rows, inv


def face_table(tri: torch.Tensor, attrs: torch.Tensor) -> torch.Tensor:
    """(9, F) triangle rows + (16, F) attrs -> the (32, F) table that
    ``bin_faces`` gathers (rows 0..8 triangle, 16..31 attrs): one binned
    gather serves geometry and attributes."""
    pad = torch.zeros((16 - tri.shape[0], tri.shape[1]), device=tri.device)
    return torch.cat([tri, pad, attrs], dim=0)


def _finish(fid, b0, b1, attr_planes, with_attrs: bool):
    mask = fid >= 0
    zero = torch.zeros((), device=fid.device)
    bary = tuple(torch.where(mask, b, zero) for b in (b0, b1, 1.0 - b0 - b1))
    if with_attrs:
        return fid, bary, attr_planes
    return fid, torch.stack(bary, dim=-1)


def _check_tiling(n_faces: int, height: int, width: int) -> int:
    if n_faces % FACE_CHUNK:
        raise ValueError(f"pad faces to a multiple of {FACE_CHUNK}")
    col_tile = min(COL_TILE, width)
    if height % ROW_TILE or width % col_tile:
        raise ValueError(f"{height}x{width} does not tile at 8x{col_tile}")
    return col_tile


def rasterize_flat(verts_screen: torch.Tensor, faces: torch.Tensor,
                   height: int, width: int,
                   attrs: Optional[torch.Tensor] = None):
    """Counterpart of ``rasterize_pallas``: (fid, bary (H,W,3)), or with
    ``attrs`` (16, F) (fid, bary as three (H,W) planes, attr planes
    (16,H,W)); background fid -1 with bary and attrs 0."""
    _check_tiling(faces.shape[0], height, width)
    tri, inv = face_rows(verts_screen, faces)
    a = attrs if attrs is not None else torch.zeros(
        (N_ATTR, faces.shape[0]), device=inv.device)
    out = raster_flat(tri, inv, a.float().contiguous(), height, width)
    return _finish(*out, with_attrs=attrs is not None)


def rasterize_binned(verts_screen: torch.Tensor, faces: torch.Tensor,
                     height: int, width: int, bin_cap: int = BIN_CAP,
                     attrs: Optional[torch.Tensor] = None):
    """Counterpart of ``rasterize_pallas_binned``; outputs as
    ``rasterize_flat``, bit-identical to it while no tile holds more
    than ``bin_cap`` faces."""
    n_faces = faces.shape[0]
    col_tile = _check_tiling(n_faces, height, width)
    if bin_cap % FACE_CHUNK:
        raise ValueError(f"bin_cap must be a multiple of {FACE_CHUNK}")
    bin_cap = min(bin_cap, n_faces)
    tri, inv = face_rows(verts_screen, faces)
    a = attrs if attrs is not None else torch.zeros(
        (N_ATTR, n_faces), device=inv.device)
    tri_t, inv_t, ids_t, counts = bin_faces(face_table(tri, a.float()), inv,
                                            height, width, col_tile, bin_cap)
    out = raster_binned(counts, tri_t, inv_t, ids_t, height, width, col_tile)
    return _finish(*out, with_attrs=attrs is not None)


def bin_overflow_stats(verts_screen: torch.Tensor, faces: torch.Tensor,
                       height: int, width: int, col_tile: int = COL_TILE,
                       cap: int = BIN_CAP):
    """(max faces per tile, number of tiles above ``cap``) as device
    scalars: the bbox-overlap counts the prestage would build."""
    tri, inv = face_rows(verts_screen, faces)
    counts = _tile_overlap(tri, inv, height, width,
                           min(col_tile, width)).sum(dim=1)
    return counts.max(), (counts > cap).sum()
