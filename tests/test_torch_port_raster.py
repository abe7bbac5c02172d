"""acr_tpu_torch rasterizer: plain versions, prestage, tier choice, render_hands.

The plain PyTorch versions of the flat and binned kernels run against
the JAX Pallas kernels in interpret mode (as tests/test_raster_pallas.py
runs them): ``fid`` and attribute planes equal, barycentrics to 1e-5.
The CUDA kernels themselves run only on a card: the test at the end
compares them with the plain versions there and skips on the CPU.
"""

import os

import numpy as np
import pytest
import torch
from scipy.spatial import ConvexHull

import jax.numpy as jnp

from acr_tpu.models.mano import load_mano_model as jax_load_mano
from acr_tpu.models.mano import mano_forward as jax_mano_forward
from acr_tpu.viz import raster as jraster
from acr_tpu.viz import raster_pallas as jp
from acr_tpu_torch.viz import raster as traster
from acr_tpu_torch.viz import raster_cuda as tc

torch.set_num_threads(2)
MANO_DIR = os.path.join(os.path.dirname(__file__), "..", "model_data", "mano")


def t(x):
    return torch.tensor(np.asarray(x))


def hull_scene(seed, n_hulls=2, size=128):
    """Convex hulls of random points on spheres (every point on the hull,
    ~600 faces each), projected; faces padded to 128."""
    rng = np.random.RandomState(seed)
    verts, faces = [], []
    for h in range(n_hulls):
        pts = rng.randn(300, 3).astype(np.float32)
        pts *= 0.05 / np.linalg.norm(pts, axis=1, keepdims=True)
        pts[:, 0] += (h - (n_hulls - 1) / 2) * 0.12
        f = ConvexHull(pts).simplices.astype(np.int32) + 300 * h
        verts.append(pts + np.array([0, 0, 1.0], np.float32))
        faces.append(f)
    faces = np.concatenate(faces)
    faces = np.concatenate(
        [faces, np.zeros(((-len(faces)) % 128, 3), np.int32)])
    screen = np.array(jraster._project(jnp.asarray(np.concatenate(verts)),
                                         200.0 * size / 128, size / 2, size / 2))
    attrs = rng.randn(16, len(faces)).astype(np.float32)
    return screen, faces, attrs


def assert_same_raster(got, want):
    fid_g, bary_g, attr_g = got
    fid_w, bary_w, attr_w = want
    np.testing.assert_array_equal(fid_g.numpy(), np.asarray(fid_w))
    for g, w in zip(bary_g, bary_w):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    np.testing.assert_array_equal(attr_g.numpy(), np.asarray(attr_w))


@pytest.mark.parametrize("size", [(128, 128), (64, 512)])
def test_flat_plain_matches_pallas(size):
    h, w = size
    screen, faces, attrs = hull_scene(0)
    if w == 512:
        screen[:, 0] *= 4.0                    # spread over two column tiles
    want = jp.rasterize_pallas(jnp.asarray(screen), jnp.asarray(faces), h, w,
                               interpret=True, attrs=jnp.asarray(attrs))
    got = tc.rasterize_flat(t(screen), t(faces), h, w, attrs=t(attrs))
    assert (got[0] >= 0).sum() > 100
    assert_same_raster(got, want)


def test_binned_plain_matches_pallas():
    screen, faces, attrs = hull_scene(1)
    assert faces.shape[0] > 128
    want = jp.rasterize_pallas_binned(jnp.asarray(screen), jnp.asarray(faces),
                                      128, 128, bin_cap=128, interpret=True,
                                      attrs=jnp.asarray(attrs))
    got = tc.rasterize_binned(t(screen), t(faces), 128, 128, bin_cap=128,
                              attrs=t(attrs))
    assert_same_raster(got, want)
    # with room for every face the binned result is the flat one, bit for bit
    roomy = tc.rasterize_binned(t(screen), t(faces), 128, 128,
                                bin_cap=faces.shape[0], attrs=t(attrs))
    flat = tc.rasterize_flat(t(screen), t(faces), 128, 128, attrs=t(attrs))
    assert torch.equal(roomy[0], flat[0]) and torch.equal(roomy[2], flat[2])
    assert all(torch.equal(g, f) for g, f in zip(roomy[1], flat[1]))


def test_plain_rasterize_without_attrs():
    screen, faces, _ = hull_scene(2)
    fid_w, bary_w = jraster.rasterize(jnp.asarray(screen), jnp.asarray(faces),
                                      128, 128)
    fid_g, bary_g = traster.rasterize(t(screen), t(faces), 128, 128)
    np.testing.assert_array_equal(fid_g.numpy(), np.asarray(fid_w))
    np.testing.assert_allclose(bary_g.numpy(), np.asarray(bary_w), atol=1e-5)


def jax_tier(max_faces, f_total):
    """The binned tier JAX's ``lax.switch`` takes for a frame whose
    fullest tile holds ``max_faces`` faces (acr_tpu/viz/raster.py:414-418):
    idx = the number of tiers below the max; None for the flat kernel."""
    tiers = [c for c in (128, 256, 512) if c < f_total]
    idx = sum(max_faces > c for c in tiers)
    return tiers[idx] if idx < len(tiers) else None


def tile_scene(n_in_tile, size=128, seed=3):
    """``n_in_tile`` small live triangles inside the first 8-row tile,
    the rest of the frame empty: the tile's count is ``n_in_tile``."""
    rng = np.random.RandomState(seed)
    c = rng.rand(n_in_tile, 2).astype(np.float32) * [size - 8, 4] + [4, 2]
    d = rng.rand(n_in_tile, 1).astype(np.float32) + 1.0
    tri = np.stack([np.concatenate([c, d], 1),
                    np.concatenate([c + [3, 0], d], 1),
                    np.concatenate([c + [0, 3], d + 0.1], 1)], 1)
    screen = tri.reshape(-1, 3).astype(np.float32)
    faces = np.arange(3 * n_in_tile, dtype=np.int32).reshape(-1, 3)
    faces = np.concatenate(
        [faces, np.zeros(((-len(faces)) % 128, 3), np.int32)])
    return screen, faces


@pytest.mark.parametrize("n_in_tile", [100, 200, 400, 600])
def test_counts_tiers_and_overflow(n_in_tile):
    screen, faces = tile_scene(n_in_tile)
    cap = min(512, faces.shape[0])
    tri = jnp.asarray(screen)[jnp.asarray(faces)]
    rows = tri.transpose(1, 2, 0).reshape(9, -1)
    xs, ys = tri[:, :, 0], tri[:, :, 1]
    area = ((xs[:, 1] - xs[:, 0]) * (ys[:, 2] - ys[:, 0])
            - (xs[:, 2] - xs[:, 0]) * (ys[:, 1] - ys[:, 0]))
    inv = jnp.where(jnp.abs(area) < 1e-9, 0.0, 1.0 / area)
    rows16 = jnp.concatenate([rows, jnp.zeros((7, rows.shape[1]))], 0)
    jt = jp._bin_faces(rows16, inv[None], 128, 128, 128, cap)
    g_rows, g_inv = tc.face_rows(t(screen), t(faces))
    table = torch.cat([g_rows, torch.zeros(7, g_rows.shape[1])])
    tt = tc.bin_faces(table, g_inv, 128, 128, 128, cap)
    # counts: the port's are unclipped, JAX's clipped to the cap
    assert int(tt[3].max()) == n_in_tile
    np.testing.assert_array_equal(tt[3].clamp(max=cap).numpy(),
                                  np.asarray(jt[3]))
    np.testing.assert_array_equal(tt[2].numpy(), np.asarray(jt[2])[:, 0])  # ids
    np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt[0]))
    mx_j, n_j = jp.bin_overflow_stats(jnp.asarray(screen), jnp.asarray(faces),
                                      128, 128, cap=512)
    mx_t, n_t = tc.bin_overflow_stats(t(screen), t(faces), 128, 128, cap=512)
    assert (int(mx_t), int(n_t)) == (int(mx_j), int(n_j))
    assert int(mx_t) == n_in_tile
    # the tier JAX's lax.switch would take, from the port's count
    want = jax_tier(int(mx_j), faces.shape[0])
    assert jax_tier(int(mx_t), faces.shape[0]) == want
    if n_in_tile > 128:
        # above capacity the highest ids drop, as in the Pallas prestage
        got = tc.rasterize_binned(t(screen), t(faces), 128, 128, bin_cap=128)
        jw = jp.rasterize_pallas_binned(jnp.asarray(screen), jnp.asarray(faces),
                                        128, 128, bin_cap=128, interpret=True)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jw[0]))
        # (faces reaching into the next tile may still win there)
        dropped = set(range(128, n_in_tile))
        assert not dropped & set(got[0][:8].numpy().ravel().tolist())


def two_hand_scene(size, dist=2.5, spread=0.09, flags=(True, True)):
    verts, faces = [], []
    for side in ("left", "right"):
        model, f = jax_load_mano(MANO_DIR, side)
        v, _, _ = jax_mano_forward(model, jnp.zeros((1, 48)), jnp.zeros((1, 10)))
        verts.append(np.asarray(v[0]))
        faces.append(f)
    verts = np.stack(verts).astype(np.float32)
    cam_trans = np.array([[-spread, 0, dist], [spread, 0, dist]], np.float32)
    return verts, cam_trans, np.array(flags), np.stack(faces)


@pytest.mark.parametrize("dist,flags,camera,tier", [
    (0.3, (True, True), "intrinsics", 256),
    (0.4, (True, True), "intrinsics", 512),
    (2.5, (True, True), "intrinsics", None),   # a tile above 512: flat kernel
    (0.4, (False, True), "intrinsics", 256),
    (0.3, (True, True), "fov", 256),
    (1.0, (True, True), "ortho", 512),
])
def test_render_hands_matches_jax(dist, flags, camera, tier):
    verts, cam_trans, det, faces = two_hand_scene(128, dist=dist, flags=flags)
    if camera == "ortho":             # unit NDC box: scale the scene up
        verts = verts * 10.0
        cam_trans[:, 0] *= 10.0
    kw = dict(size=128, focal=1265.0 * 128 / 512, camera=camera, fov_deg=22.5)
    want = jraster.render_hands(jnp.asarray(verts), jnp.asarray(cam_trans),
                                jnp.asarray(det), jnp.asarray(faces),
                                backend="pallas", interpret=True, **kw)
    got = traster.render_hands(t(verts), t(cam_trans), t(det),
                               t(faces.astype(np.int64)), **kw)
    assert got.shape == (128, 128, 4)
    screen, all_faces, _ = traster._scene_screen_faces(
        (t(verts) + t(cam_trans)[:, None]).reshape(-1, 3), t(det),
        t(faces.astype(np.int64)), 778, 128, kw["focal"], camera, 22.5)
    mx, _ = tc.bin_overflow_stats(screen, all_faces, 128, 128)
    assert jax_tier(int(mx), all_faces.shape[0]) == tier
    assert (got[..., 3] > 0).sum() > 50
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    planar = traster.render_hands(t(verts), t(cam_trans), t(det),
                                  t(faces.astype(np.int64)), planar=True, **kw)
    np.testing.assert_array_equal(planar.numpy(), np.moveaxis(got.numpy(), -1, 0))
    probe = traster.render_overflow_probe(t(verts), t(cam_trans), t(det),
                                          t(faces.astype(np.int64)), **kw)
    want_probe = jraster.render_overflow_probe(
        jnp.asarray(verts), jnp.asarray(cam_trans), jnp.asarray(det),
        jnp.asarray(faces), **kw)
    np.testing.assert_array_equal(probe.numpy(), np.asarray(want_probe))


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    screen, faces, attrs = hull_scene(4, size=512)
    dev = torch.device("cuda")
    s, f, a = t(screen).to(dev), t(faces).to(dev), t(attrs).to(dev)
    tri, inv = tc.face_rows(s, f)
    want = tc.raster_flat_plain(tri, inv, a, 512, 512)
    got = tc.raster_flat(tri, inv, a, 512, 512)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    binned = tc.bin_faces(tc.face_table(tri, a), inv, 512, 512, 256, 512)
    tri_t, inv_t, ids_t, counts = binned
    got_b = tc.raster_binned(counts, tri_t, inv_t, ids_t, 512, 512, 256)
    for g, w in zip(got_b, got):
        assert torch.equal(g, w)
