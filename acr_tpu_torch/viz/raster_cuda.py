"""The rasterizer's CUDA kernels, their plain PyTorch versions, and the prestages.

Counterpart of ``acr_tpu/viz/raster_pallas.py``:

* ``raster_flat`` launches ``raster_flat_kernel`` (``csrc/raster.cu``),
  the port of the Pallas ``_raster_kernel``: the exact path for any
  frame. Its TPU original folds every face at every pixel; the kernel
  folds, per block of 8 x 128 pixels, only the faces that
  ``flat_cull_mask`` keeps for the block (the binned prestage's
  inclusive bbox test), in ascending id order, which changes no bit;
* ``raster_binned`` launches ``raster_binned_kernel``, the port of
  ``_raster_kernel_binned``: the same math over each 8 x ``col_tile``
  pixel tile's bbox-binned face list, bounded by the tile's live count;
* ``bin_faces`` is the prestage (``_bin_faces``): a STABLE argsort of
  the tile x face overlap keeps every tile's list in ascending face id,
  so the lowest-id tie rule holds and the binned kernel is bit-identical
  to the flat one while no tile exceeds ``cap``. Above ``cap`` the
  highest ids drop, as on the TPU, unless the binned kernel is given the
  full face table: then it draws an overflowing tile's remaining faces
  from the table, and equals the flat kernel on every frame
  (``rasterize_binned(..., exact=True)``, the render below 1024 px).
  ``bin_overflow_stats`` counts the overflowing tiles;
* ``raster_banded`` launches ``raster_banded_kernel``, the port of
  ``_raster_kernel_banded``, the path of every render at 1024 px and
  above: ``bin_faces_banded`` gathers face rows once per 256-row band
  into a table of ``band_cap`` columns and gives each tile only an
  ascending list of int32 slots into its band's table; the kernel reads
  the rows of each slot straight from the table. Bit-identical to the
  flat kernel while no band holds more than ``band_cap`` faces and no
  tile more than ``cap``; ``banded_overflow_stats`` is its gate and
  ``band_overflow_stats`` the probe's band count.

Each wrapper runs its plain PyTorch version for tensors on the CPU and
launches its kernel for CUDA tensors, or raises; it never falls back.
The plain versions compute the edge math with the same operations in
the same order, one rounding per operation, so on the card a kernel and
its plain version agree bit for bit. ``LAUNCHES`` counts kernel launches.

The kernels are built at first use, with the port's other CUDA sources,
into one shared library by ``acr_tpu_torch.ops.cuda_lib``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from acr_tpu_torch.ops import cuda_lib

ROW_TILE = 8
FACE_CHUNK = 128      # faces padded to a multiple; plain versions fold chunks
COL_TILE = 256
BIN_CAP = 512
BAND_H = 256          # banded kernel: rows per band
BAND_CAP = 2048       # banded kernel: face-table columns per band
FLAT_TILE_H, FLAT_TILE_W = 8, 128   # flat kernel: pixels per block
N_ATTR = 16
# rows of the (32, F) face table: 0..8 triangle, 9 inverse area, 10 global
# face id as f32 (exact below 2^24), 16..31 attributes
ROW_INV, ROW_GID, ROW_ATTR = 9, 10, 16

# kernel launches since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {"raster_flat": 0, "raster_binned": 0,
                            "raster_banded": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _outputs(height: int, width: int, device):
    return (torch.empty((height, width), dtype=torch.int32, device=device),
            torch.empty((height, width), dtype=torch.float32, device=device),
            torch.empty((height, width), dtype=torch.float32, device=device),
            torch.empty((N_ATTR, height, width), dtype=torch.float32,
                        device=device))


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
    cuda_lib.check("tri", tri, torch.float32, (9, n_faces), dev)
    cuda_lib.check("inv", inv, torch.float32, (n_faces,), dev)
    cuda_lib.check("attrs", attrs, torch.float32, (N_ATTR, n_faces), dev)
    fid, b0, b1, attr_planes = _outputs(height, width, dev)
    cuda_lib.launch(cuda_lib.library().acr_raster_flat, dev,
                    tri.data_ptr(), inv.data_ptr(),
                    attrs.data_ptr(), n_faces, height, width, fid.data_ptr(),
                    b0.data_ptr(), b1.data_ptr(), attr_planes.data_ptr())
    LAUNCHES["raster_flat"] += 1
    return fid, b0, b1, attr_planes


# ---------------------------------------------------------------------------
# binned kernel (B1) and its prestage
# ---------------------------------------------------------------------------

def face_bboxes(tri_rows: torch.Tensor):
    """(xmin, xmax, ymin, ymax), each (F,), of triangle rows (R, F).
    Rows 0, 3, 6 and 1, 4, 7 are taken as strided slices: a list index
    would be copied to the device with a host synchronisation."""
    xs, ys = tri_rows[0:9:3], tri_rows[1:9:3]
    return xs.min(0).values, xs.max(0).values, ys.min(0).values, ys.max(0).values


def _block_overlap(tri_rows: torch.Tensor, inv_area: torch.Tensor,
                   n_ty: int, n_tx: int, tile_h: int,
                   tile_w: int) -> torch.Tensor:
    """(n_ty * n_tx, F) bool: live face f's bbox reaches the tile_h x
    tile_w tile (row-major grid order). tri_rows (R, F), rows 0..8 the
    triangle; a face is live where ``inv_area != 0``. A NaN screen
    coordinate makes the face's bbox NaN, so it reaches no tile."""
    dev = tri_rows.device
    xmin, xmax, ymin, ymax = face_bboxes(tri_rows)
    ty = torch.arange(n_ty, dtype=torch.float32, device=dev) * tile_h
    tx = torch.arange(n_tx, dtype=torch.float32, device=dev) * tile_w
    # pixel centers in a tile span [t0 + 0.5, t0 + tile - 0.5]
    y_hit = (ymin[None] <= ty[:, None] + tile_h) & (ymax[None] >= ty[:, None])
    x_hit = (xmin[None] <= tx[:, None] + tile_w) & (xmax[None] >= tx[:, None])
    live = inv_area != 0.0
    return (y_hit[:, None, :] & x_hit[None, :, :]
            & live[None, None, :]).reshape(n_ty * n_tx, -1)


def _tile_overlap(tri_rows: torch.Tensor, inv_area: torch.Tensor,
                  height: int, width: int, col_tile: int) -> torch.Tensor:
    """(T, F) bool: live face f's bbox reaches tile t (8 x ``col_tile``
    pixels, row-major grid order)."""
    return _block_overlap(tri_rows, inv_area, height // ROW_TILE,
                          width // col_tile, ROW_TILE, col_tile)


def flat_cull_mask(tri: torch.Tensor, inv: torch.Tensor, height: int,
                   width: int) -> torch.Tensor:
    """(n_blocks, F) bool: the faces the flat kernel folds in each of its
    ``FLAT_TILE_H`` x ``FLAT_TILE_W`` pixel blocks, ceil(H / 8) x
    ceil(W / 128) in row-major grid order (the kernel's ``face_reaches``).
    Used by the tests and by the kernel's bound."""
    return _block_overlap(tri, inv, -(-height // FLAT_TILE_H),
                          -(-width // FLAT_TILE_W), FLAT_TILE_H, FLAT_TILE_W)


def bin_faces(tri_rows: torch.Tensor, inv_area: torch.Tensor, height: int,
              width: int, col_tile: int, cap: int):
    """Bin faces into fixed-capacity per-tile lists by bbox overlap.

    tri_rows (R, F) with rows 0..8 the triangle, inv_area (F,) ->
    tri_t (T, R, cap), inv_t (T, cap), ids_t (T, cap) int32 global ids
    (-1 for empty slots) and counts (T,) int32, the live faces that
    reach each tile (JAX's ``_bin_faces`` clips them to ``cap``; the
    binned kernel does, or draws the rest from the face table);
    T = (H/8) * (W/col_tile) tiles in row-major grid order. The stable
    argsort keeps each tile's faces in ascending id order; a tile above
    ``cap`` keeps its lowest ``cap`` ids.
    """
    dev = tri_rows.device
    overlap = _tile_overlap(tri_rows, inv_area, height, width, col_tile)
    order = torch.argsort((~overlap).to(torch.uint8), dim=1,
                          stable=True)[:, :cap]                  # (T, cap)
    counts = overlap.sum(dim=1).to(torch.int32)
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


def _fold_tiles(gx_all: torch.Tensor, gy_all: torch.Tensor, rows_of,
                n_faces: int):
    """The ascending fold of ``n_faces`` faces over each tile's pixel
    centres gx_all, gy_all (T, px). ``rows_of(t0, t1)`` gives the faces
    of tiles [t0, t1) as (rows (t, 9+, n), inv (t, n)), or shared by all
    tiles as (rows (9+, n), inv (n,)). Returns the winner's face index
    (-1 for none), b0 and b1, each (T, px)."""
    dev = gx_all.device
    n_tiles, px = gx_all.shape
    step = _pixel_budget(px)
    out = []
    for t0 in range(0, n_tiles, step):
        t1 = min(t0 + step, n_tiles)
        gx, gy = gx_all[t0:t1, :, None], gy_all[t0:t1, :, None]
        rows, inv = rows_of(t0, t1)
        shape = (t1 - t0, px)
        carry = (torch.full(shape, float("inf"), device=dev),
                 torch.full(shape, -1, dtype=torch.int32, device=dev),
                 torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
        for s0 in range(0, n_faces, FACE_CHUNK):
            s1 = min(s0 + FACE_CHUNK, n_faces)
            w0, w1, depth = _edge_fold(gx, gy, rows, inv, s0, s1)
            carry = _fold_step(carry, w0, w1, depth, s0)
        out.append(carry[1:])
    return tuple(torch.cat(c) for c in zip(*out))


def raster_binned_plain(counts: torch.Tensor, tri_t: torch.Tensor,
                        inv_t: torch.Tensor, ids_t: torch.Tensor,
                        height: int, width: int, col_tile: int,
                        table: Optional[torch.Tensor] = None):
    """Plain PyTorch version of ``raster_binned`` (any device).

    counts (T,) int32, tri_t (T, 32, cap) (rows 0..8 triangle, 16..31
    attribute rows), inv_t (T, cap), ids_t (T, cap) int32, as
    ``bin_faces`` makes them. It folds every slot (the kernel stops at
    the tile's count, clipped to ``cap``; slots past it have inv = 0 and
    never win).

    With ``table`` (32, F), the face table the slots were binned from
    (``face_table`` with the inverse areas), a tile whose count exceeds
    ``cap`` is drawn from every face of the table in ascending id order:
    the faces that can win at its pixels all reach it, so the winner is
    the kernel's, which folds only its kept slots and the reaching faces
    after them. Without it, faces above ``cap`` drop. The overflowing
    tiles are found with one host read. Same outputs as
    ``raster_flat_plain``.
    """
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
    slot, b0, b1 = _fold_tiles(
        gx_all, gy_all, lambda t0, t1: (tri_t[t0:t1], inv_t[t0:t1]), cap)
    won = slot >= 0                                             # (T, px)
    gid = ids_t.gather(1, slot.clamp(min=0).long())
    fid = torch.where(won, gid, torch.full_like(gid, -1))
    idx = slot.clamp(min=0).long()[:, None, :].expand(-1, N_ATTR, -1)
    picked = tri_t[:, ROW_ATTR:ROW_ATTR + N_ATTR].gather(2, idx)  # (T, 16, px)
    picked = torch.where(won[:, None, :], picked, torch.zeros_like(picked))
    if table is not None:
        over = torch.nonzero(counts > cap)[:, 0]
        if len(over):
            f, w0, w1 = _fold_tiles(
                gx_all[over], gy_all[over],
                lambda t0, t1: (table[:9], table[ROW_INV]), table.shape[1])
            fid[over], b0[over], b1[over] = f, w0, w1
            a = table[ROW_ATTR:ROW_ATTR + N_ATTR][:, f.clamp(min=0).long()]
            a = a.transpose(0, 1)                               # (n, 16, px)
            picked[over] = torch.where((f >= 0)[:, None, :], a,
                                       torch.zeros_like(a))
    plane = lambda t: _tiles_to_planes(t, height, width, col_tile)
    return plane(fid), plane(b0), plane(b1), plane(picked)


def raster_binned(counts: torch.Tensor, tri_t: torch.Tensor,
                  inv_t: torch.Tensor, ids_t: torch.Tensor, height: int,
                  width: int, col_tile: int,
                  table: Optional[torch.Tensor] = None):
    """Binned z-buffer raster: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Same arguments and outputs as
    ``raster_binned_plain``; the kernel finds the overflowing tiles
    itself, without a host read."""
    if inv_t.device.type == "cpu":
        return raster_binned_plain(counts, tri_t, inv_t, ids_t, height,
                                   width, col_tile, table)
    if inv_t.device.type != "cuda":
        raise ValueError(f"raster_binned: unsupported device {inv_t.device}")
    dev = inv_t.device
    n_tiles, cap = inv_t.shape
    if (height % ROW_TILE or width % col_tile
            or (col_tile % FLAT_TILE_W and col_tile != width)
            or n_tiles != (height // ROW_TILE) * (width // col_tile)):
        raise ValueError(f"raster_binned: {n_tiles} tiles do not tile "
                         f"{height}x{width} at 8x{col_tile} (col_tile a "
                         f"multiple of {FLAT_TILE_W} or the whole width)")
    cuda_lib.check("counts", counts, torch.int32, (n_tiles,), dev)
    cuda_lib.check("tri_t", tri_t, torch.float32, (n_tiles, 32, cap), dev)
    cuda_lib.check("inv_t", inv_t, torch.float32, (n_tiles, cap), dev)
    cuda_lib.check("ids_t", ids_t, torch.int32, (n_tiles, cap), dev)
    n_faces = 0 if table is None else table.shape[1]
    if table is not None:
        cuda_lib.check("table", table, torch.float32, (32, n_faces), dev)
    fid, b0, b1, attr_planes = _outputs(height, width, dev)
    cuda_lib.launch(cuda_lib.library().acr_raster_binned, dev,
                    counts.data_ptr(), tri_t.data_ptr(), inv_t.data_ptr(),
                    ids_t.data_ptr(), cap,
                    None if table is None else table.data_ptr(), n_faces,
                    height, width, col_tile, fid.data_ptr(), b0.data_ptr(),
                    b1.data_ptr(), attr_planes.data_ptr())
    LAUNCHES["raster_binned"] += 1
    return fid, b0, b1, attr_planes


# ---------------------------------------------------------------------------
# banded kernel (B3) and its two-level prestage
# ---------------------------------------------------------------------------

def bin_faces_banded(full_rows: torch.Tensor, xmin: torch.Tensor,
                     xmax: torch.Tensor, ymin: torch.Tensor,
                     ymax: torch.Tensor, live: torch.Tensor, height: int,
                     width: int, col_tile: int, band_h: int, band_cap: int,
                     cap: int):
    """Two-level binning prestage of the banded kernel
    (``_bin_faces_banded``, output for output).

    full_rows (R, F) face rows in the table layout (``ROW_INV``,
    ``ROW_GID``, ``ROW_ATTR``); xmin/xmax/ymin/ymax/live (F,) face bboxes
    and liveness.

    Level 1: faces -> row bands of ``band_h`` px by y-bbox overlap; a
    STABLE argsort of the band x face hit matrix gathers each band's
    faces, in ascending id, into a table (n_bands, R, band_cap). Dead
    columns get inverse area 0 (never win) and id -1.
    Level 2: per (8 x ``col_tile``) tile, the slots of its band's table
    whose bbox reaches the tile, as an ascending int32 list (T, 1, cap):
    the keys are the slot ids, ``band_cap`` for a slot that does not
    reach the tile, and a sort keeps the lowest ``cap`` (the only ties
    are sentinels). Also returns tilenc (T,) int32, the live chunks of
    128 slots per tile, and fetchnc (T,) int32, the chunks of the band
    table up to the tile's highest slot (the TPU kernel's fetch bound).

    A band (tile) above ``band_cap`` (``cap``) drops its highest ids.
    """
    dev = full_rows.device
    n_bands = height // band_h
    tpb_y = band_h // ROW_TILE
    n_tx = width // col_tile
    f32 = torch.float32
    by = torch.arange(n_bands, dtype=f32, device=dev) * band_h
    band_hit = ((ymin[None, :] <= by[:, None] + band_h)
                & (ymax[None, :] >= by[:, None]) & live[None, :])
    border = torch.argsort((~band_hit).to(torch.uint8), dim=1,
                           stable=True)[:, :band_cap]          # (nb, band_cap)
    bcounts = band_hit.sum(dim=1).clamp(max=band_cap)
    bslot_live = (torch.arange(band_cap, device=dev)[None, :]
                  < bcounts[:, None])
    table = full_rows.T[border].transpose(1, 2).contiguous()   # (nb, R, band_cap)
    table[:, ROW_INV] *= bslot_live.to(f32)
    table[:, ROW_GID] = torch.where(bslot_live, table[:, ROW_GID],
                                    torch.full((), -1.0, device=dev))

    xmin_b, xmax_b = xmin[border], xmax[border]                # (nb, band_cap)
    ymin_b, ymax_b = ymin[border], ymax[border]
    ty = by[:, None] + torch.arange(tpb_y, dtype=f32, device=dev)[None, :] \
        * ROW_TILE
    y_hit = ((ymin_b[:, None, :] <= ty[..., None] + ROW_TILE)
             & (ymax_b[:, None, :] >= ty[..., None]))          # (nb, ty, cap)
    tx = torch.arange(n_tx, dtype=f32, device=dev) * col_tile
    x_hit = ((xmin_b[:, None, :] <= tx[None, :, None] + col_tile)
             & (xmax_b[:, None, :] >= tx[None, :, None]))      # (nb, tx, cap)
    ov = (y_hit[:, :, None, :] & x_hit[:, None, :, :]
          & bslot_live[:, None, None, :]).reshape(-1, band_cap)
    keys = torch.where(
        ov, torch.arange(band_cap, dtype=torch.int32, device=dev)[None, :],
        torch.full((), band_cap, dtype=torch.int32, device=dev))
    ids_t = torch.sort(keys, dim=1).values[:, :cap].contiguous()
    counts_t = ov.sum(dim=1).clamp(max=cap).to(torch.int32)
    tilenc = torch.div(counts_t + FACE_CHUNK - 1, FACE_CHUNK,
                       rounding_mode="floor")
    max_slot = ids_t.gather(1, (counts_t - 1).clamp(min=0).long()[:, None])[:, 0]
    fetchnc = torch.where(counts_t > 0,
                          torch.div(max_slot, FACE_CHUNK,
                                    rounding_mode="floor") + 1,
                          torch.zeros_like(max_slot))
    return table, ids_t[:, None, :], tilenc, fetchnc


def raster_banded_plain(table: torch.Tensor, ids_t: torch.Tensor,
                        tilenc: torch.Tensor, fetchnc: torch.Tensor,
                        height: int, width: int, col_tile: int, band_h: int):
    """Plain PyTorch version of ``raster_banded`` (any device).

    table (n_bands, 32, band_cap), ids_t (T, 1, cap) int32, tilenc and
    fetchnc (T,) int32, as ``bin_faces_banded`` makes them. Each tile's
    slots are gathered from its band's table and folded like the binned
    plain version; the fold stops at the frame's fullest tile (one host
    read of ``tilenc``), and a tile's sentinel slots fold with inverse
    area 0, so they never win. Same outputs as ``raster_flat_plain``.
    """
    del fetchnc
    dev = table.device
    band_cap = table.shape[2]
    n_tiles, _, cap = ids_t.shape
    n_tx = width // col_tile
    px = ROW_TILE * col_tile
    tiles_per_band = (band_h // ROW_TILE) * n_tx
    n_slots = min(int(tilenc.max()) * FACE_CHUNK, cap) if n_tiles else 0
    lin = torch.arange(px, device=dev)
    loc_x = (lin % col_tile).to(torch.float32)
    loc_y = torch.div(lin, col_tile, rounding_mode="floor").to(torch.float32)
    tiles = torch.arange(n_tiles, device=dev)
    org_x = ((tiles % n_tx) * col_tile).to(torch.float32)
    org_y = (torch.div(tiles, n_tx, rounding_mode="floor")
             * ROW_TILE).to(torch.float32)
    gx_all = (org_x[:, None] + loc_x[None]) + 0.5              # (T, px)
    gy_all = (org_y[:, None] + loc_y[None]) + 0.5
    band_of_tile = torch.div(tiles, tiles_per_band, rounding_mode="floor")
    step = _pixel_budget(px)
    fids, b0s, b1s, attrs = [], [], [], []
    for t0 in range(0, n_tiles, step):
        t1 = min(t0 + step, n_tiles)
        tab = table[band_of_tile[t0:t1]]                       # (t, 32, band_cap)
        slots = ids_t[t0:t1, 0, :n_slots]
        live = slots < band_cap
        col = slots.clamp(max=band_cap - 1).long()
        rows = tab[:, :ROW_INV + 1].gather(
            2, col[:, None, :].expand(-1, ROW_INV + 1, -1))   # (t, 10, n)
        inv = torch.where(live, rows[:, ROW_INV], torch.zeros((), device=dev))
        gx, gy = gx_all[t0:t1, :, None], gy_all[t0:t1, :, None]
        shape = (t1 - t0, px)
        carry = (torch.full(shape, float("inf"), device=dev),
                 torch.full(shape, -1, dtype=torch.int32, device=dev),
                 torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
        for s0 in range(0, n_slots, FACE_CHUNK):
            s1 = min(s0 + FACE_CHUNK, n_slots)
            w0, w1, depth = _edge_fold(gx, gy, rows, inv, s0, s1)
            carry = _fold_step(carry, w0, w1, depth, s0)
        won = carry[1] >= 0                                    # (t, px)
        # the winner's column in its band's table
        win_col = (col.gather(1, carry[1].clamp(min=0).long()) if n_slots
                   else torch.zeros(shape, dtype=torch.long, device=dev))
        gid = tab[:, ROW_GID].gather(1, win_col).to(torch.int32)
        fids.append(torch.where(won, gid, torch.full_like(gid, -1)))
        picked = tab[:, ROW_ATTR:ROW_ATTR + N_ATTR].gather(
            2, win_col[:, None, :].expand(-1, N_ATTR, -1))     # (t, 16, px)
        attrs.append(torch.where(won[:, None, :], picked,
                                 torch.zeros_like(picked)))
        b0s.append(carry[2])
        b1s.append(carry[3])
    plane = lambda t: _tiles_to_planes(t, height, width, col_tile)
    return (plane(torch.cat(fids)), plane(torch.cat(b0s)),
            plane(torch.cat(b1s)), plane(torch.cat(attrs)))


def raster_banded(table: torch.Tensor, ids_t: torch.Tensor,
                  tilenc: torch.Tensor, fetchnc: torch.Tensor, height: int,
                  width: int, col_tile: int, band_h: int):
    """Banded z-buffer raster: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Same arguments and outputs as
    ``raster_banded_plain``."""
    if table.device.type == "cpu":
        return raster_banded_plain(table, ids_t, tilenc, fetchnc, height,
                                   width, col_tile, band_h)
    if table.device.type != "cuda":
        raise ValueError(f"raster_banded: unsupported device {table.device}")
    dev = table.device
    n_bands, _, band_cap = table.shape
    n_tiles, _, cap = ids_t.shape
    if (height % band_h or band_h % ROW_TILE or width % col_tile
            or n_bands != height // band_h
            or n_tiles != (height // ROW_TILE) * (width // col_tile)):
        raise ValueError(f"raster_banded: {n_bands} bands of {band_h} rows "
                         f"and {n_tiles} tiles do not tile {height}x{width} "
                         f"at 8x{col_tile}")
    cuda_lib.check("table", table, torch.float32, (n_bands, 32, band_cap), dev)
    cuda_lib.check("ids_t", ids_t, torch.int32, (n_tiles, 1, cap), dev)
    cuda_lib.check("tilenc", tilenc, torch.int32, (n_tiles,), dev)
    cuda_lib.check("fetchnc", fetchnc, torch.int32, (n_tiles,), dev)
    fid, b0, b1, attr_planes = _outputs(height, width, dev)
    cuda_lib.launch(cuda_lib.library().acr_raster_banded, dev,
                    tilenc.data_ptr(), table.data_ptr(), ids_t.data_ptr(),
                    band_cap, cap, band_h, height, width, col_tile,
                    fid.data_ptr(), b0.data_ptr(), b1.data_ptr(),
                    attr_planes.data_ptr())
    LAUNCHES["raster_banded"] += 1
    return fid, b0, b1, attr_planes


# ---------------------------------------------------------------------------
# launchers: the counterparts of rasterize_pallas{,_binned,_banded}
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


def face_table(tri: torch.Tensor, attrs: torch.Tensor,
               inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(9, F) triangle rows + (16, F) attrs -> the (32, F) table that
    the prestages gather (rows 0..8 triangle, 16..31 attrs): one gather
    serves geometry and attributes. With ``inv`` (F,) the rows of the
    banded layout are filled too: ``ROW_INV`` the inverse areas and
    ``ROW_GID`` the global face ids as f32."""
    pad = torch.zeros((16 - tri.shape[0], tri.shape[1]), device=tri.device)
    if inv is not None:
        pad[ROW_INV - 9] = inv
        pad[ROW_GID - 9] = torch.arange(tri.shape[1], dtype=torch.float32,
                                        device=tri.device)
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
                     attrs: Optional[torch.Tensor] = None,
                     exact: bool = False):
    """Counterpart of ``rasterize_pallas_binned``; outputs as
    ``rasterize_flat``, bit-identical to it while no tile holds more
    than ``bin_cap`` faces. Above that a tile drops its highest ids, as
    on the TPU, unless ``exact``: then the kernel draws the tile's other
    faces from the full face table, and the result is the flat one on
    every frame."""
    n_faces = faces.shape[0]
    col_tile = _check_tiling(n_faces, height, width)
    if bin_cap % FACE_CHUNK:
        raise ValueError(f"bin_cap must be a multiple of {FACE_CHUNK}")
    bin_cap = min(bin_cap, n_faces)
    tri, inv = face_rows(verts_screen, faces)
    a = attrs if attrs is not None else torch.zeros(
        (N_ATTR, n_faces), device=inv.device)
    table = face_table(tri, a.float(), inv)
    tri_t, inv_t, ids_t, counts = bin_faces(table, inv, height, width,
                                            col_tile, bin_cap)
    out = raster_binned(counts, tri_t, inv_t, ids_t, height, width, col_tile,
                        table=table if exact else None)
    return _finish(*out, with_attrs=attrs is not None)


def rasterize_banded(verts_screen: torch.Tensor, faces: torch.Tensor,
                     height: int, width: int, band_cap: int = BAND_CAP,
                     bin_cap: int = BIN_CAP, band_h: int = BAND_H,
                     attrs: Optional[torch.Tensor] = None):
    """Counterpart of ``rasterize_pallas_banded``; outputs as
    ``rasterize_flat``, bit-identical to it while no band holds more
    than ``band_cap`` faces and no tile more than ``bin_cap``."""
    n_faces = faces.shape[0]
    col_tile = _check_tiling(n_faces, height, width)
    if bin_cap % FACE_CHUNK or band_cap % FACE_CHUNK:
        raise ValueError(f"bin_cap and band_cap must be multiples of "
                         f"{FACE_CHUNK}")
    if height % band_h or band_h % ROW_TILE:
        raise ValueError(f"band_h={band_h} must divide {height} and be a "
                         f"multiple of {ROW_TILE}")
    if n_faces > 1 << 24:
        raise ValueError("face ids above 2^24 do not round-trip through f32")
    band_cap = min(band_cap, n_faces)
    bin_cap = min(bin_cap, band_cap)
    tri, inv = face_rows(verts_screen, faces)
    a = attrs if attrs is not None else torch.zeros(
        (N_ATTR, n_faces), device=inv.device)
    table, ids_t, tilenc, fetchnc = bin_faces_banded(
        face_table(tri, a.float(), inv), *face_bboxes(tri), inv != 0.0,
        height, width, col_tile, band_h, band_cap, bin_cap)
    out = raster_banded(table, ids_t, tilenc, fetchnc, height, width,
                        col_tile, band_h)
    return _finish(*out, with_attrs=attrs is not None)


def bin_overflow_stats(verts_screen: torch.Tensor, faces: torch.Tensor,
                       height: int, width: int, col_tile: int = COL_TILE,
                       cap: int = BIN_CAP):
    """(max faces per tile, number of tiles above ``cap``) as device
    scalars: the bbox-overlap counts the prestage would build. Below
    1024 px the binned kernel draws the tiles above ``cap`` from the full
    face table; JAX's dispatch takes the flat kernel for such a frame."""
    tri, inv = face_rows(verts_screen, faces)
    counts = _tile_overlap(tri, inv, height, width,
                           min(col_tile, width)).sum(dim=1)
    return counts.max(), (counts > cap).sum()


def _band_counts(ymin: torch.Tensor, ymax: torch.Tensor, live: torch.Tensor,
                 height: int, band_h: int) -> torch.Tensor:
    """(n_bands,) live faces whose y-bbox reaches each band."""
    by = torch.arange(height // band_h, dtype=torch.float32,
                      device=ymin.device) * band_h
    hit = ((ymin[None] <= by[:, None] + band_h) & (ymax[None] >= by[:, None])
           & live[None])
    return hit.sum(dim=1)


def banded_overflow_stats(verts_screen: torch.Tensor, faces: torch.Tensor,
                          height: int, width: int, col_tile: int = COL_TILE,
                          band_h: int = BAND_H):
    """(max faces per tile, max faces per band) as device scalars: the
    banded kernel's gate on its two capacities."""
    tri, inv = face_rows(verts_screen, faces)
    counts = _tile_overlap(tri, inv, height, width,
                           min(col_tile, width)).sum(dim=1)
    _, _, ymin, ymax = face_bboxes(tri)
    return counts.max(), _band_counts(ymin, ymax, inv != 0.0, height,
                                      band_h).max()


def band_overflow_stats(verts_screen: torch.Tensor, faces: torch.Tensor,
                        height: int, band_h: int = BAND_H,
                        band_cap: int = BAND_CAP):
    """(max faces per band, number of bands above ``band_cap``) as
    device scalars: the band half of the overflow probe."""
    tri, inv = face_rows(verts_screen, faces)
    _, _, ymin, ymax = face_bboxes(tri)
    counts = _band_counts(ymin, ymax, inv != 0.0, height, band_h)
    return counts.max(), (counts > band_cap).sum()
