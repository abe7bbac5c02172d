"""On-device mesh renderer: z-buffer rasterizer + Lambert shading in PyTorch.

Counterpart of ``acr_tpu/viz/raster.py``. Camera model (the pyrender
setup, reference renderer_pyrd.py:20-47): camera at the origin,
IntrinsicsCamera(f, f, cx, cy), which for pixel coordinates is a direct
pinhole with image-down y: u = f x / z + cx, v = f y / z + cy. The
reference's three 0.5-intensity lights along -z with 0.3 ambient reduce
to one Lambert term on -normal_z.

``render_hands`` draws the frame JAX's dispatch (``raster.py:385-432``)
draws. Below 1024 px JAX takes the smallest binned capacity tier
(128/256/512 faces per tile) that holds the frame's fullest tile, or the
exact flat kernel when a tile holds more, by ``lax.switch`` on the
device. Here one path draws every frame: the binned kernel at
``min(BIN_CAP, F)`` faces per tile, which draws a tile above that from
the full face table. Its result is the flat kernel's on every frame, so
it is JAX's, and nothing is read to the host. At 1024 px and above: the
banded kernel, unless a tile holds more than ``BIN_CAP`` faces or a band
more than ``BAND_CAP``, and then the flat kernel; the two maxima are
read once on the host, that render's only mid-step synchronisation.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from acr_tpu_torch.viz import raster_cuda
from acr_tpu_torch.viz.raster_cuda import (
    BAND_CAP,
    BAND_H,
    BIN_CAP,
    FACE_CHUNK,
    N_ATTR,
    band_overflow_stats,
    banded_overflow_stats,
    bin_overflow_stats,
    rasterize_banded,
    rasterize_binned,
    rasterize_flat,
)

VISIBLE_WEIGHT = 0.9          # reference: acr/visualization.py:157
# hand colors indexed by type (0=left, 1=right); reference pre_colors
# (acr/visualization.py:76)
PRE_COLORS = np.array([[0.46, 0.59, 0.64], [0.94, 0.71, 0.53]], np.float32)


def compute_vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals. verts (V,3), faces (F,3) -> (V,3).

    The sums are accumulated in a fixed order (``index_put`` with
    ``accumulate``, sorted on CUDA; the same sums as ``index_add`` on the
    CPU): MANO's vertex 767 has faces whose normals nearly cancel (a sum
    of norm about 1e-12), so its direction, and the shading of the pixels
    around it, followed the order of ``index_add``'s CUDA atomics
    (ROADMAP C7)."""
    faces = faces.long()
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    vn = torch.zeros_like(verts)
    for i in range(3):
        vn = vn.index_put((faces[:, i],), fn, accumulate=True)
    norm = torch.linalg.norm(vn, dim=-1, keepdim=True)
    return vn / torch.clamp(norm, min=1e-12)


def _project(verts: torch.Tensor, focal: float, cx: float, cy: float):
    """(V, 3) camera-space -> (u, v) pixels + depth, z clamped positive."""
    z = torch.clamp(verts[:, 2], min=1e-4)
    u = focal * verts[:, 0] / z + cx
    v = focal * verts[:, 1] / z + cy
    return torch.stack([u, v, z], dim=-1)


def fov_focal_px(fov_deg: float, size: int) -> float:
    """Pixel focal length of a FoV perspective camera (pytorch3d
    FoVPerspectiveCameras, reference: renderer_pt3d.py:74-86)."""
    return (size / 2.0) / float(np.tan(np.radians(fov_deg) / 2.0))


def _project_ortho(verts: torch.Tensor, half: float, cx: float, cy: float):
    """FoV-orthographic projection with the unit NDC box
    (reference: renderer_pt3d.py:88-110): u = cx + half * x."""
    u = half * verts[:, 0] + cx
    v = half * verts[:, 1] + cy
    z = torch.clamp(verts[:, 2], min=1e-4)
    return torch.stack([u, v, z], dim=-1)


def rasterize(verts_screen: torch.Tensor, faces: torch.Tensor,
              height: int, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain z-buffer rasterization on any device (the counterpart of the
    JAX scan rasterizer): (face_id (H, W) int32, -1 background; bary
    (H, W, 3) of the winner). F must be a multiple of 128."""
    tri, inv = raster_cuda.face_rows(verts_screen, faces)
    fid, b0, b1, _ = raster_cuda.raster_flat_plain(tri, inv, None, height, width)
    return raster_cuda._finish(fid, b0, b1, None, with_attrs=False)


def shade(face_id: torch.Tensor, bary: torch.Tensor, faces: torch.Tensor,
          normals: torch.Tensor, face_colors: torch.Tensor,
          ambient: float = 0.3, directional: float = 1.5) -> torch.Tensor:
    """Lambert shading by per-pixel gathers -> (H, W, 4) RGBA in [0, 1];
    alpha = coverage. ``face_id`` (H, W), ``bary`` (H, W, 3), ``faces``
    (F, 3), ``normals`` (V, 3), ``face_colors`` (F, 3). The counterpart of
    JAX's ``shade``; the render path shades from the kernels' attribute
    planes (``shade_from_attrs``) instead."""
    safe_id = torch.clamp(face_id, min=0)
    tri_n = normals[faces[safe_id]]                    # (H, W, 3, 3)
    n = torch.einsum("hwk,hwkc->hwc", bary, tri_n)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    lambert = torch.clamp(-n[..., 2], min=0.0)
    intensity = torch.clamp(ambient + directional * lambert, 0.0, 1.0)
    rgb = face_colors[safe_id] * intensity[..., None]
    alpha = (face_id >= 0).to(rgb.dtype)
    return torch.cat([rgb * alpha[..., None], alpha[..., None]], dim=-1)


def shade_from_attrs(face_id: torch.Tensor,
                     bary_planes: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                     attr_planes: torch.Tensor, ambient: float = 0.3,
                     directional: float = 1.5, planar: bool = False) -> torch.Tensor:
    """Lambert shading from the winner's attribute planes -> RGBA in [0, 1].

    ``attr_planes`` (16, H, W): rows 0..8 the winning face's corner
    normals, 9..11 its hand color; alpha = coverage. Returns (H, W, 4),
    or (4, H, W) with ``planar``.
    """
    if not (isinstance(bary_planes, tuple) and len(bary_planes) == 3):
        raise TypeError("bary_planes must be a tuple of three (H, W) planes")
    b0, b1, b2 = bary_planes
    n = [b0 * attr_planes[c] + b1 * attr_planes[3 + c]
         + b2 * attr_planes[6 + c] for c in range(3)]
    norm = torch.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
    nz = n[2] / torch.clamp(norm, min=1e-12)
    lambert = torch.clamp(-nz, min=0.0)
    intensity = torch.clamp(ambient + directional * lambert, 0.0, 1.0)
    alpha = (face_id >= 0).to(intensity.dtype)
    rgb = [(attr_planes[9 + c] * intensity) * alpha for c in range(3)]
    return torch.stack(rgb + [alpha], dim=0 if planar else -1)


def _scene_screen_faces(all_verts: torch.Tensor, detection_flag: torch.Tensor,
                        faces: torch.Tensor, verts_per_hand: int, size: int,
                        focal: float, camera: str, fov_deg: float):
    """Offset/mask faces, pad to a 128 multiple with degenerate faces,
    project to screen. Shared by render_hands and the overflow probe."""
    offs = torch.arange(2, dtype=faces.dtype, device=faces.device)[:, None, None] \
        * verts_per_hand
    all_faces = torch.where(detection_flag[:, None, None], faces + offs,
                            torch.zeros_like(faces)).reshape(-1, 3)
    pad = (-all_faces.shape[0]) % FACE_CHUNK
    all_faces = torch.cat([all_faces, all_faces.new_zeros((pad, 3))], dim=0)
    if camera == "ortho":
        screen = _project_ortho(all_verts, size / 2.0, size / 2.0, size / 2.0)
    else:
        f = fov_focal_px(fov_deg, size) if camera == "fov" else focal
        screen = _project(all_verts, f, size / 2.0, size / 2.0)
    return screen, all_faces, pad


def _uses_bands(size: int, f_total: int) -> bool:
    """The high-resolution dispatch: the banded kernel or flat."""
    return size >= 1024 and f_total > FACE_CHUNK


def render_overflow_probe(verts: torch.Tensor, cam_trans: torch.Tensor,
                          detection_flag: torch.Tensor, faces: torch.Tensor,
                          size: int = 512, focal: float = 1265.0,
                          camera: str = "intrinsics",
                          fov_deg: float = 22.5) -> torch.Tensor:
    """Rasterizer capacity telemetry for one frame: one (4,) int32 tensor
    [max_faces_per_tile, n_overflowing_tiles, max_faces_per_band,
    n_overflowing_bands]; the band fields are 0 below 1024 px."""
    all_verts = (verts + cam_trans[:, None, :]).reshape(-1, 3)
    screen, all_faces, _ = _scene_screen_faces(
        all_verts, detection_flag, faces, verts.shape[1], size, focal,
        camera, fov_deg)
    mx_t, n_t = bin_overflow_stats(screen, all_faces, size, size, cap=BIN_CAP)
    f_total = all_faces.shape[0]
    if _uses_bands(size, f_total):
        mx_b, n_b = band_overflow_stats(screen, all_faces, size, band_h=BAND_H,
                                        band_cap=min(BAND_CAP, f_total))
    else:
        mx_b = n_b = torch.zeros((), dtype=mx_t.dtype, device=mx_t.device)
    return torch.stack([mx_t, n_t, mx_b, n_b]).to(torch.int32)


def prepare_scene(verts: torch.Tensor, cam_trans: torch.Tensor,
                  detection_flag: torch.Tensor, faces: torch.Tensor,
                  size: int = 512, focal: float = 1265.0,
                  camera: str = "intrinsics", fov_deg: float = 22.5):
    """One frame's two-hand scene -> (screen verts (V, 3), faces (F, 3)
    padded to a 128 multiple, per-face attribute rows (16, F): the three
    corner normals (rows 0..8) and the hand color (9..11))."""
    all_verts = (verts + cam_trans[:, None, :]).reshape(-1, 3)
    screen, all_faces, _ = _scene_screen_faces(
        all_verts, detection_flag, faces, verts.shape[1], size, focal,
        camera, fov_deg)
    dev = all_verts.device
    normals = compute_vertex_normals(all_verts, all_faces)
    f_total = all_faces.shape[0]
    # faces [n_hand, 2 n_hand) are the right hand's, the padding the left
    # color's; the colors enter as scalars, so no host-to-device copy
    right = torch.arange(f_total, device=dev) // faces.shape[1] == 1
    color_rows = [torch.where(right, float(PRE_COLORS[1, c]),
                              float(PRE_COLORS[0, c])) for c in range(3)]
    corner_n = normals[all_faces.long()].permute(1, 2, 0)       # (3, 3, F)
    attrs = torch.cat([corner_n.reshape(9, f_total), torch.stack(color_rows),
                       torch.zeros((N_ATTR - 12, f_total), device=dev)],
                      dim=0).contiguous()
    return screen, all_faces, attrs


def render_hands(verts: torch.Tensor, cam_trans: torch.Tensor,
                 detection_flag: torch.Tensor, faces: torch.Tensor,
                 size: int = 512, focal: float = 1265.0,
                 camera: str = "intrinsics", fov_deg: float = 22.5,
                 planar: bool = False) -> torch.Tensor:
    """Render both hand meshes of one image -> (size, size, 4) RGBA, or
    (4, size, size) with ``planar``.

    verts (2, 778, 3) root-relative; cam_trans (2, 3); detection_flag
    (2,) bool; faces (2, 1538, 3) integer. Undetected hands collapse to a
    degenerate vertex and are never rasterized. On CUDA tensors the
    binned kernel draws the frame below 1024 px, without a host read, and
    the banded or flat kernel at 1024 px and above; on CPU tensors their
    plain versions do.
    """
    screen, all_faces, attrs = prepare_scene(
        verts, cam_trans, detection_flag, faces, size, focal, camera, fov_deg)
    if not _uses_bands(size, all_faces.shape[0]):
        out = rasterize_binned(screen, all_faces, size, size,
                               bin_cap=BIN_CAP, attrs=attrs, exact=True)
    elif banded_fits(screen, all_faces, size):
        out = rasterize_banded(screen, all_faces, size, size,
                               band_cap=BAND_CAP, bin_cap=BIN_CAP,
                               band_h=BAND_H, attrs=attrs)
    else:
        out = rasterize_flat(screen, all_faces, size, size, attrs=attrs)
    face_id, bary, attr_img = out
    return shade_from_attrs(face_id, bary, attr_img, planar=planar)


def banded_fits(screen: torch.Tensor, all_faces: torch.Tensor,
                size: int) -> bool:
    """Whether the banded kernel draws this frame exactly: no tile above
    ``BIN_CAP`` faces and no band above ``min(BAND_CAP, F)`` (the gate
    of ``raster.py:400-403``). One host read of the two maxima (a sync)."""
    mx_t, mx_b = banded_overflow_stats(screen, all_faces, size, size,
                                       band_h=BAND_H)
    max_tile, max_band = torch.stack([mx_t, mx_b]).tolist()
    return max_tile <= BIN_CAP and max_band <= min(BAND_CAP, all_faces.shape[0])
