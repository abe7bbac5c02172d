"""The demo's mesh render: both hands under a pinhole camera at the
origin (u = f x / z + S/2, v = f y / z + S/2), a z-buffer at the pixel
centres where the nearest face wins (the lower face id on equal depth),
and Lambert shading of the interpolated vertex normals: intensity
clamp(0.3 + 1.5 max(-n_z, 0), 0, 1) times the hand's colour (left
(0.46, 0.59, 0.64), right (0.94, 0.71, 0.53)), alpha = coverage."""

from __future__ import annotations

import numpy as np
import torch

COLORS = ((0.46, 0.59, 0.64), (0.94, 0.71, 0.53))


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted normals, summed in float64."""
    v = verts.double()
    fn = torch.linalg.cross(v[faces[:, 1]] - v[faces[:, 0]],
                            v[faces[:, 2]] - v[faces[:, 0]], dim=-1)
    vn = torch.zeros_like(v)
    for k in range(3):
        vn.index_add_(0, faces[:, k], fn)
    return vn / vn.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def rasterize(screen: torch.Tensor, faces: torch.Tensor, size: int,
              chunk: int = 32):
    """screen (V, 3) = (u, v, z), faces (F, 3) -> face id (S, S) (-1 on
    background) and the winner's barycentrics (S, S, 3). Faces are
    visited in id order, ``chunk`` at a time over every pixel."""
    dev = screen.device
    tri = screen[faces]                                        # (F, 3, 3)
    area = ((tri[:, 1, 0] - tri[:, 0, 0]) * (tri[:, 2, 1] - tri[:, 0, 1])
            - (tri[:, 2, 0] - tri[:, 0, 0]) * (tri[:, 1, 1] - tri[:, 0, 1]))
    inv = torch.where(area.abs() < 1e-9, torch.zeros_like(area), 1.0 / area)
    g = torch.arange(size, device=dev, dtype=torch.float32) + 0.5
    px = g[None, :, None].expand(size, size, 1)
    py = g[:, None, None].expand(size, size, 1)
    zbuf = torch.full((size, size), float("inf"), device=dev)
    fid = torch.full((size, size), -1, dtype=torch.long, device=dev)
    bary = torch.zeros((size, size, 3), device=dev)
    for f0 in range(0, tri.shape[0], chunk):
        t = tri[f0:f0 + chunk]
        (ax, ay, az), (bx, by, bz), (cx, cy, cz) = \
            [t[:, k].unbind(-1) for k in range(3)]
        iv = inv[f0:f0 + chunk]
        w0 = ((cx - bx) * (py - by) - (cy - by) * (px - bx)) * iv
        w1 = ((ax - cx) * (py - cy) - (ay - cy) * (px - cx)) * iv
        w2 = 1.0 - w0 - w1
        z = w0 * az + w1 * bz + w2 * cz
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (iv != 0)
        z = torch.where(inside, z, torch.full_like(z, float("inf")))
        best = z.argmin(-1, keepdim=True)
        bz_ = z.gather(-1, best)[..., 0]
        win = bz_ < zbuf
        zbuf = torch.where(win, bz_, zbuf)
        fid = torch.where(win, best[..., 0] + f0, fid)
        w = torch.stack([w0.gather(-1, best)[..., 0],
                         w1.gather(-1, best)[..., 0]], -1)
        w = torch.cat([w, 1.0 - w.sum(-1, keepdim=True)], -1)
        bary = torch.where(win[..., None], w, bary)
    return fid, bary


def render(verts: torch.Tensor, cam_trans: torch.Tensor, detected,
           faces: np.ndarray, size: int, focal: float,
           bf16: bool = False) -> np.ndarray:
    """verts (2, 778, 3) root-aligned, cam_trans (2, 3), detected (2,),
    faces (2, F, 3) -> (S, S, 4) float32 RGBA on the host. The camera
    and the edge tests run in float32, one operation at a time; ``bf16``
    (a control) rounds the screen positions to bfloat16."""
    dev = verts.device
    pts, tris, colors = [], [], []
    for h in range(2):
        if not bool(detected[h]):
            continue
        n = sum(p.shape[0] for p in pts)
        pts.append(verts[h].float() + cam_trans[h].float())
        tris.append(torch.as_tensor(faces[h], device=dev) + n)
        colors.append(torch.tensor(COLORS[h], device=dev)
                      .expand(faces[h].shape[0], 3))
    if not pts:
        return np.zeros((size, size, 4), np.float32)
    world, tri, color = torch.cat(pts), torch.cat(tris), torch.cat(colors)
    z = torch.clamp(world[:, 2], min=1e-4)
    screen = torch.stack([focal * world[:, 0] / z + size / 2.0,
                          focal * world[:, 1] / z + size / 2.0, z], -1)
    if bf16:
        screen = screen.bfloat16().float()
    fid, bary = rasterize(screen, tri, size)
    normals = vertex_normals(world, tri).float()
    hit = fid >= 0
    f = fid.clamp(min=0)
    n = (bary[..., :, None] * normals[tri[f]]).sum(-2)
    nz = n[..., 2] / n.norm(dim=-1).clamp(min=1e-12)
    light = (0.3 + 1.5 * (-nz).clamp(min=0)).clamp(0, 1)
    rgb = color[f] * light[..., None] * hit[..., None]
    return torch.cat([rgb, hit[..., None].float()], -1).cpu().numpy()
