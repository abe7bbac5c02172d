"""The flat kernel's block cull (B2) on the CPU.

``raster_flat_kernel`` folds, per block of 8 x 128 pixels, only the faces
that ``flat_cull_mask`` keeps for the block. The kernel itself runs only
on a card, so this test rebuilds its result from the plain version:
each block's window rasterized over only that block's surviving faces,
with their global ids. It must equal the full ``raster_flat_plain`` bit
for bit (fid, barycentrics and attribute planes), and JAX's
``rasterize_pallas`` in interpret mode at the tolerance of
tests/test_torch_port_raster.py (fid and attributes equal, bary 1e-5).
On the rest-pose hands JAX may pick the other one of two copies of a
repeated triangle, whose depths differ in the last bit; such pixels are
checked to be that tie and nothing else.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acr_tpu.viz import raster_pallas as jp
from acr_tpu_torch.models import mano as tm
from acr_tpu_torch.viz import raster as traster
from acr_tpu_torch.viz import raster_cuda as tc

torch.set_num_threads(2)
MANO_DIR = os.path.join(os.path.dirname(__file__), "..", "model_data", "mano")
SIZE = 128


def _pad_faces(faces):
    return np.concatenate(
        [faces, np.zeros(((-len(faces)) % 128, 3), np.int32)]).astype(np.int32)


def rest_pose_scene():
    """Both MANO hands in rest pose at 0.4 m, the image path's scene."""
    verts, faces = [], []
    for side in ("left", "right"):
        model, f = tm.load_mano_model(MANO_DIR, side, device="cpu")
        v, _, _ = tm.mano_forward(model, torch.zeros(1, 48), torch.zeros(1, 10))
        verts.append(v[0])
        faces.append(torch.as_tensor(f, dtype=torch.long))
    cam_trans = torch.tensor([[-0.09, 0.0, 0.4], [0.09, 0.0, 0.4]])
    screen, all_faces, attrs = traster.prepare_scene(
        torch.stack(verts), cam_trans, torch.tensor([True, True]),
        torch.stack(faces), SIZE, 1265.0 * SIZE / 512)
    return screen.numpy(), all_faces.numpy().astype(np.int32), attrs.numpy()


def random_triangles(rng, n, lo=0.0, hi=SIZE, size=(2.0, 14.0)):
    c = rng.uniform(lo, hi, (n, 1, 2))
    d = rng.uniform(*size, (n, 3, 2)) * rng.choice([-1, 1], (n, 3, 2))
    xy = c + d * [[1, 0], [0, 1], [1, 1]]
    z = rng.uniform(1.0, 2.0, (n, 3, 1))
    return np.concatenate([xy, z], axis=2).astype(np.float32)   # (n, 3, 3)


def sliver_scene(rng):
    """Thin slivers whose bbox edges sit exactly on block borders (rows
    at multiples of 8, the columns 0 and 128), some spanning a border,
    with duplicated faces at equal depth (the lowest id must win)."""
    tris = []
    for k in range(1, SIZE // 8):
        yb = 8.0 * k
        for x0 in rng.uniform(0, SIZE - 40, 3):
            z = rng.uniform(1.0, 2.0)
            tris += [[[x0, yb - 0.5, z], [x0 + 30, yb - 0.5, z], [x0 + 15, yb, z]],
                     [[x0, yb, z], [x0 + 30, yb + 0.5, z], [x0 + 20, yb, z]],
                     [[x0, yb - 3.0, z], [x0 + 1.0, yb + 3.0, z],
                      [x0 + 0.5, yb, z + 0.1]]]
        tris += [[[0.0, yb - 4, 1.5], [0.6, yb + 4, 1.5], [0.0, yb + 4, 1.5]],
                 [[128.0, yb - 4, 1.5], [127.4, yb + 4, 1.5],
                  [128.0, yb + 4, 1.5]]]
    tris = np.asarray(tris, np.float32)
    tris = np.concatenate([tris, tris[::5], random_triangles(rng, 200)])
    return tris


def degenerate_scene(rng):
    """Live faces mixed with zero-area ones: collinear, repeated corners,
    and areas below the 1e-9 cut."""
    tris = random_triangles(rng, 300)
    bad = random_triangles(rng, 120)
    bad[:40, 2] = bad[:40, 0]                                   # repeated
    bad[40:80, 2, :2] = 0.5 * (bad[40:80, 0, :2] + bad[40:80, 1, :2])
    bad[80:, 1, :2] = bad[80:, 0, :2] + 1e-6                    # tiny
    bad[80:, 2, :2] = bad[80:, 0, :2] + [1e-6, 0]
    mixed = np.concatenate([tris, bad])
    return mixed[rng.permutation(len(mixed))]


def nan_scene(rng):
    """A fan of faces around one vertex whose coordinates are NaN, among
    ordinary faces."""
    tris = random_triangles(rng, 300)
    fan = random_triangles(rng, 40, lo=40, hi=90, size=(5, 30))
    fan[:, 0] = np.nan
    return np.concatenate([tris, fan])


def triangle_soup(tris):
    """(n, 3, 3) corners -> screen verts (3n, 3), faces padded to 128."""
    screen = tris.reshape(-1, 3).astype(np.float32)
    faces = np.arange(len(screen), dtype=np.int32).reshape(-1, 3)
    return screen, _pad_faces(faces)


def scene(name):
    rng = np.random.RandomState(7)
    if name == "rest_pose":
        return rest_pose_scene()
    screen, faces = triangle_soup({"slivers": sliver_scene,
                                   "degenerate": degenerate_scene,
                                   "nan_vertex": nan_scene}[name](rng))
    attrs = rng.randn(16, faces.shape[0]).astype(np.float32)
    return screen, faces, attrs


def culled_raster(tri, inv, attrs, height, width):
    """The flat raster assembled block by block, each block from the
    plain version over only the faces its cull keeps (global ids)."""
    mask = tc.flat_cull_mask(tri, inv, height, width)
    n_tx = -(-width // tc.FLAT_TILE_W)
    fid = torch.full((height, width), -1, dtype=torch.int32)
    b0, b1 = torch.zeros(height, width), torch.zeros(height, width)
    planes = torch.zeros(tc.N_ATTR, height, width)
    for blk in range(mask.shape[0]):
        ids = torch.nonzero(mask[blk])[:, 0]
        if not len(ids):
            continue
        y0 = (blk // n_tx) * tc.FLAT_TILE_H
        x0 = (blk % n_tx) * tc.FLAT_TILE_W
        win = (slice(y0, y0 + tc.FLAT_TILE_H), slice(x0, x0 + tc.FLAT_TILE_W))
        f, w0, w1, a = tc.raster_flat_plain(tri[:, ids].contiguous(), inv[ids],
                                            attrs[:, ids].contiguous(),
                                            height, width)
        local = f[win]
        fid[win] = torch.where(local >= 0, ids[local.clamp(min=0).long()]
                               .to(torch.int32), local)
        b0[win], b1[win] = w0[win], w1[win]
        planes[(slice(None),) + win] = a[(slice(None),) + win]
    return mask, (fid, b0, b1, planes)


@pytest.mark.parametrize("name", ["rest_pose", "slivers", "degenerate",
                                  "nan_vertex"])
def test_flat_cull_matches_brute_force_and_jax(name):
    screen, faces, attrs = scene(name)
    s_t, f_t, a_t = (torch.from_numpy(x) for x in (screen, faces, attrs))
    tri, inv = tc.face_rows(s_t, f_t)
    mask, got = culled_raster(tri, inv, a_t, SIZE, SIZE)
    want = tc.raster_flat_plain(tri, inv, a_t, SIZE, SIZE)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    covered = int((got[0] >= 0).sum())
    assert covered > 200
    # the cull drops most (face, block) pairs but keeps every winner's
    kept = mask.float().mean().item()
    assert kept < 0.5, kept
    n_tx = -(-SIZE // tc.FLAT_TILE_W)
    ys, xs = torch.nonzero(got[0] >= 0, as_tuple=True)
    blocks = (ys // tc.FLAT_TILE_H) * n_tx + xs // tc.FLAT_TILE_W
    assert bool(mask[blocks, got[0][ys, xs].long()].all())
    if name == "nan_vertex":
        nan_faces = torch.isnan(tri[:6]).any(dim=0)
        assert int(nan_faces.sum()) == 40 and not mask[:, nan_faces].any()
    if name == "slivers":
        # a face whose bbox ends exactly on a row border is kept by both
        # blocks that share the border
        ymin, ymax = tri[[1, 4, 7]].min(0).values, tri[[1, 4, 7]].max(0).values
        on_border = (ymax % tc.FLAT_TILE_H == 0) & (ymax > ymin) & (inv != 0)
        assert int(on_border.sum()) > 10
        for f in torch.nonzero(on_border)[:, 0].tolist():
            assert int(mask[:, f].sum()) >= 2
    jfid, jbary, jattr = jp.rasterize_pallas(
        jnp.asarray(screen), jnp.asarray(faces), SIZE, SIZE, interpret=True,
        attrs=jnp.asarray(attrs))
    fid, bary, planes = tc._finish(*got, with_attrs=True)
    fid, jfid = fid.numpy(), np.asarray(jfid)
    same = fid == jfid
    if name == "rest_pose":
        # the synthetic MANO mesh repeats some triangles with their
        # corners in another order: at a pixel both copies cover, the two
        # depths differ in the last bit only, and JAX's rounding may pick
        # the other copy
        ys, xs = np.nonzero(~same)
        z_got = _depth(tri.numpy(), inv.numpy(), fid[ys, xs], xs, ys)
        z_jax = _depth(tri.numpy(), inv.numpy(), jfid[ys, xs], xs, ys)
        assert np.all(np.abs(z_got - z_jax) <= 1e-6 * np.abs(z_got))
        assert (~same).mean() < 0.01
    else:
        assert same.all()
    for g, w in zip(bary, jbary):
        np.testing.assert_allclose(g.numpy()[same], np.asarray(w)[same],
                                   atol=1e-5)
    np.testing.assert_array_equal(planes.numpy()[:, same],
                                  np.asarray(jattr)[:, same])


def _depth(tri, inv, f, x, y):
    """Depth of faces ``f`` at pixel centres (x, y), the kernel's math
    in float32; each face must cover its pixel."""
    gx, gy = x.astype(np.float32) + 0.5, y.astype(np.float32) + 0.5
    ax, ay, az, bx, by, bz, cx, cy, cz = tri[:, f]
    w0 = ((cx - bx) * (gy - by) - (cy - by) * (gx - bx)) * inv[f]
    w1 = ((ax - cx) * (gy - cy) - (ay - cy) * (gx - cx)) * inv[f]
    w2 = 1.0 - w0 - w1
    assert (np.minimum(np.minimum(w0, w1), w2) >= 0).all() and (f >= 0).all()
    return w0 * az + w1 * bz + w2 * cz


@pytest.mark.cuda
@pytest.mark.parametrize("height,width", [(SIZE, SIZE), (75, 200), (120, 100)])
@pytest.mark.parametrize("name", ["rest_pose", "slivers", "degenerate",
                                  "nan_vertex"])
def test_cuda_flat_kernel_matches_plain(name, height, width):
    """The kernel's own cull (``face_reaches``) on the same scenes, and at
    ragged sizes (rows not a multiple of 8, columns not of 128, the edge
    through the drawn faces): fid, barycentrics and attribute planes equal
    to ``raster_flat_plain`` bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    screen, faces, attrs = scene(name)
    s_t, f_t, a_t = (torch.from_numpy(x).to(dev) for x in (screen, faces, attrs))
    tri, inv = tc.face_rows(s_t, f_t)
    before = tc.LAUNCHES["raster_flat"]
    got = tc.raster_flat(tri, inv, a_t, height, width)
    want = tc.raster_flat_plain(tri, inv, a_t, height, width)
    torch.cuda.synchronize()
    assert tc.LAUNCHES["raster_flat"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[0] >= 0).sum()) > 100
