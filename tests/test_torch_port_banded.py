"""acr_tpu_torch banded rasterizer (B3): prestage, plain version, gates,
the high-resolution dispatch of render_hands.

The prestage must equal ``_bin_faces_banded`` output for output; the
plain version of the banded kernel runs against the Pallas kernel in
interpret mode (as tests/test_raster_pallas.py runs it): ``fid`` and
attribute planes equal, barycentrics to 1e-5. The CUDA kernel runs only
on a card: the test at the end compares it with its plain version and
with the flat kernel there, and skips on the CPU.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import ConvexHull

import jax.numpy as jnp

from acr_tpu.viz import raster as jraster
from acr_tpu.viz import raster_pallas as jp
from acr_tpu_torch.viz import raster as traster
from acr_tpu_torch.viz import raster_cuda as tc
from test_torch_port_raster import assert_same_raster, hull_scene, t

torch.set_num_threads(2)


def two_hull_scene(seed, dx=30.0, dy=20.0, dense=False):
    """Two hulls offset by (-+dx, -+dy) px at 128 px: those of
    test_raster_pallas.py:123-161 (hulls of 300 Gaussian points, about
    200 faces in all, every band and tile within the caps below), or
    with ``dense`` those of ``hull_scene`` (every point on the hull,
    about 1200 faces: bands and tiles above them)."""
    if dense:
        screen, faces, attrs = hull_scene(seed)
        screen = screen.copy()
        half = screen.shape[0] // 2
    else:
        rng = np.random.RandomState(seed)
        pts = [rng.randn(300, 3).astype(np.float32) * 0.05 for _ in range(2)]
        faces = [ConvexHull(p).simplices.astype(np.int32) for p in pts]
        faces = np.concatenate([faces[0], faces[1] + 300])
        faces = np.concatenate(
            [faces, np.zeros(((-len(faces)) % 128, 3), np.int32)])
        screen = np.array(jraster._project(
            jnp.asarray(np.concatenate(pts) + [0, 0, 1.0]), 200.0, 64.0, 64.0))
        attrs = rng.randn(16, len(faces)).astype(np.float32)
        half = 300
    screen[:half, 0] -= dx
    screen[:half, 1] -= dy
    screen[half:, 0] += dx
    screen[half:, 1] += dy
    return screen, faces, attrs


def stacked_scene(n=256):
    """``n`` stacked triangles over pixel (32, 32), nearer for higher id
    (test_raster_pallas.py:97-115)."""
    tris = [[[20, 20, 1.0 - k * 1e-3], [44, 20, 1.0 - k * 1e-3],
             [32, 44, 1.0 - k * 1e-3]] for k in range(n)]
    screen = np.asarray(tris, np.float32).reshape(-1, 3)
    faces = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    attrs = np.random.RandomState(n).randn(16, n).astype(np.float32)
    return screen, faces, attrs


def jax_full_rows(screen, faces, attrs):
    """full_rows as rasterize_pallas_banded builds them, and the bboxes."""
    tri = jnp.asarray(screen)[jnp.asarray(faces)]
    f_total = faces.shape[0]
    rows = tri.transpose(1, 2, 0).reshape(9, f_total)
    xs, ys = tri[:, :, 0], tri[:, :, 1]
    area = ((xs[:, 1] - xs[:, 0]) * (ys[:, 2] - ys[:, 0])
            - (xs[:, 2] - xs[:, 0]) * (ys[:, 1] - ys[:, 0]))
    inv = jnp.where(jnp.abs(area) < 1e-9, 0.0, 1.0 / area)
    full = jnp.concatenate([rows, inv[None],
                            jnp.arange(f_total, dtype=jnp.float32)[None],
                            jnp.zeros((5, f_total)), jnp.asarray(attrs)], 0)
    return full, (xs.min(1), xs.max(1), ys.min(1), ys.max(1), inv != 0.0)


@pytest.mark.parametrize("scene,size,band_h,band_cap,cap", [
    ("hulls", (128, 128), 32, 256, 128),
    ("hulls_dense", (128, 128), 64, 256, 256),
    ("hulls_dense", (128, 512), 64, 512, 128),
    ("stacked", (64, 128), 32, 128, 128),
])
def test_prestage_equals_jax(scene, size, band_h, band_cap, cap):
    if scene.startswith("hulls"):
        screen, faces, attrs = two_hull_scene(0, dense=scene == "hulls_dense")
        if size[1] == 512:
            screen[:, 0] *= 4.0
    else:
        screen, faces, attrs = stacked_scene()
    h, w = size
    col_tile = min(tc.COL_TILE, w)
    band_cap = min(band_cap, faces.shape[0])      # as the launchers clamp
    cap = min(cap, band_cap)
    full, bbox = jax_full_rows(screen, faces, attrs)
    want = jp._bin_faces_banded(full, *bbox, h, w, col_tile, band_h,
                                band_cap, cap)
    tri, inv = tc.face_rows(t(screen), t(faces))
    rows = tc.face_table(tri, t(attrs), inv)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(full))
    got = tc.bin_faces_banded(rows, *tc.face_bboxes(tri), inv != 0.0, h, w,
                              col_tile, band_h, band_cap, cap)
    for name, g, wv in zip(("table", "ids_t", "tilenc", "fetchnc"), got, want):
        assert g.dtype == (torch.float32 if name == "table" else torch.int32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv), err_msg=name)
    assert int(got[2].max()) > 0


@pytest.mark.parametrize("case", ["scan_case", "attrs_case", "dense",
                                  "empty", "drop_tile", "drop_band"])
def test_rasterize_banded_plain_matches_pallas(case):
    """The cases of test_raster_pallas.py:123-173 plus the overflow drop,
    at the tile cap and at the band cap."""
    h, w = 128, 128
    if case == "scan_case":
        screen, faces, attrs = two_hull_scene(1)
        kw = dict(band_cap=256, bin_cap=128, band_h=32)
    elif case == "attrs_case":
        screen, faces, attrs = two_hull_scene(2, dx=0.0, dy=25.0)
        kw = dict(band_cap=256, bin_cap=256, band_h=64)
    elif case == "dense":              # bands and tiles above the caps
        screen, faces, attrs = two_hull_scene(1, dense=True)
        kw = dict(band_cap=256, bin_cap=128, band_h=32)
    elif case == "empty":
        screen = np.zeros((3, 3), np.float32)
        faces = np.zeros((256, 3), np.int32)
        attrs = np.ones((16, 256), np.float32)
        h, kw = 64, dict(band_cap=128, bin_cap=128, band_h=32)
    else:
        screen, faces, attrs = stacked_scene()
        h = 64
        kw = dict(band_cap=256 if case == "drop_tile" else 128,
                  bin_cap=128, band_h=32)
    want = jp.rasterize_pallas_banded(jnp.asarray(screen), jnp.asarray(faces),
                                      h, w, interpret=True,
                                      attrs=jnp.asarray(attrs), **kw)
    got = tc.rasterize_banded(t(screen), t(faces), h, w, attrs=t(attrs), **kw)
    assert_same_raster(got, want)
    fid = got[0].numpy()
    if case == "empty":
        assert (fid == -1).all()
        assert all((b == 0).all() for b in got[1]) and (got[2] == 0).all()
    elif case.startswith("drop"):
        # the nearest kept face wins: the highest id below capacity
        assert fid[fid >= 0].max() == 127
    elif case == "dense":
        mx_t, mx_b = tc.banded_overflow_stats(t(screen), t(faces), h, w,
                                              band_h=kw["band_h"])
        assert int(mx_t) > kw["bin_cap"] and int(mx_b) > kw["band_cap"]
    else:
        assert (fid >= 0).sum() > 100
        # both capacities hold every face here: the flat kernel's bits
        flat = tc.rasterize_flat(t(screen), t(faces), h, w, attrs=t(attrs))
        assert torch.equal(got[0], flat[0]) and torch.equal(got[2], flat[2])
        assert all(torch.equal(g, f) for g, f in zip(got[1], flat[1]))
    plain = tc.rasterize_banded(t(screen), t(faces), h, w, **kw)
    np.testing.assert_array_equal(plain[0].numpy(), fid)


@pytest.mark.parametrize("band_h,band_cap", [(32, 64), (64, 1024), (128, 128)])
def test_overflow_stats_equal_jax(band_h, band_cap):
    screen, faces, _ = two_hull_scene(3, dense=True)
    s, f = jnp.asarray(screen), jnp.asarray(faces)
    want_tb = jp.banded_overflow_stats(s, f, 128, 128, band_h=band_h)
    got_tb = tc.banded_overflow_stats(t(screen), t(faces), 128, 128,
                                      band_h=band_h)
    assert [int(x) for x in got_tb] == [int(x) for x in want_tb]
    want_b = jp.band_overflow_stats(s, f, 128, band_h=band_h,
                                    band_cap=band_cap)
    got_b = tc.band_overflow_stats(t(screen), t(faces), 128, band_h=band_h,
                                   band_cap=band_cap)
    assert [int(x) for x in got_b] == [int(x) for x in want_b]
    assert int(got_b[0]) >= int(got_tb[0]) > 0


def quad_scene():
    """The small-mesh scene of test_raster_pallas.py:187-208: two quads,
    faces padded to 200 so the banded path is taken."""
    half = 0.04
    quad = np.array([[-half, -half, 0], [half, -half, 0],
                     [half, half, 0], [-half, half, 0]], np.float32)
    verts = np.zeros((2, 778, 3), np.float32)
    verts[0, :4] = quad + [-0.1, -0.08, 0]
    verts[1, :4] = quad + [0.1, 0.08, 0]
    faces = np.tile(np.concatenate([np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                                    np.zeros((98, 3), np.int32)]), (2, 1, 1))
    trans = np.array([[0, 0, 1.0], [0, 0, 1.0]], np.float32)
    return verts, trans, np.array([True, True]), faces


def test_render_hands_1024_matches_jax():
    verts, trans, det, faces = quad_scene()
    kw = dict(size=1024, focal=1600.0)
    want = jraster.render_hands(jnp.asarray(verts), jnp.asarray(trans),
                                jnp.asarray(det), jnp.asarray(faces),
                                backend="pallas", interpret=True, **kw)
    args = (t(verts), t(trans), t(det), t(faces.astype(np.int64)))
    screen, all_faces, _ = traster.prepare_scene(*args, **kw)
    assert traster.banded_fits(screen, all_faces, 1024)
    got = traster.render_hands(*args, **kw)
    assert float(got[..., 3].sum()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    probe = traster.render_overflow_probe(*args, **kw)
    want_probe = jraster.render_overflow_probe(
        jnp.asarray(verts), jnp.asarray(trans), jnp.asarray(det),
        jnp.asarray(faces), **kw)
    np.testing.assert_array_equal(probe.numpy(), np.asarray(want_probe))
    assert int(probe[2]) > 0


def band_overflow_scene():
    """test_raster_pallas.py:272-305: both hands' 3076 faces inside one
    256 px band, every tile under the tile cap."""
    n_verts = 778
    cols = 56
    i = np.arange(n_verts)
    xs = (-0.45 + 0.90 * (i % cols) / (cols - 1)).astype(np.float32)
    ys = (0.30 + 0.08 * (i // cols) / (n_verts // cols)
          + 0.002 * (i % 2)).astype(np.float32)
    verts = np.stack([xs, ys, np.zeros(n_verts, np.float32)], axis=1)
    verts = np.stack([verts, verts])
    trans = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    f = np.arange(1538) % (n_verts - 2)
    faces = np.stack([f, f + 1, f + 2], axis=1).astype(np.int32)
    return verts, trans, np.array([True, True]), np.stack([faces, faces])


def test_band_overflow_probe_and_dispatch(monkeypatch):
    verts, trans, det, faces = band_overflow_scene()
    kw = dict(size=1024, focal=1000.0)
    args = (t(verts), t(trans), t(det), t(faces.astype(np.int64)))
    probe = traster.render_overflow_probe(*args, **kw)
    want = jraster.render_overflow_probe(
        jnp.asarray(verts), jnp.asarray(trans), jnp.asarray(det),
        jnp.asarray(faces), **kw)
    np.testing.assert_array_equal(probe.numpy(), np.asarray(want))
    mx, n_over, mx_band, n_band = probe.tolist()
    assert mx_band > tc.BAND_CAP and n_band >= 1 and mx <= tc.BIN_CAP
    screen, all_faces, _ = traster.prepare_scene(*args, **kw)
    assert not traster.banded_fits(screen, all_faces, 1024)
    # the dispatch, without drawing 1024 px on the CPU: record the launcher
    taken = []

    def stub(name):
        def launcher(screen, faces, h, w, **_):
            taken.append(name)
            fid = torch.full((h, w), -1, dtype=torch.int32)
            zero = torch.zeros((h, w))
            return fid, (zero, zero, zero), torch.zeros((tc.N_ATTR, h, w))
        return launcher
    for name in ("rasterize_flat", "rasterize_banded", "rasterize_binned"):
        monkeypatch.setattr(traster, name, stub(name))
    traster.render_hands(*args, **kw)
    assert taken == ["rasterize_flat"]
    taken.clear()
    traster.render_hands(*quad_scene_args(), size=1024, focal=1600.0)
    assert taken == ["rasterize_banded"]


def quad_scene_args():
    verts, trans, det, faces = quad_scene()
    return t(verts), t(trans), t(det), t(faces.astype(np.int64))


@pytest.mark.cuda
def test_cuda_banded_kernel_matches_plain_and_flat():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for case in ("hulls", "empty"):
        if case == "hulls":
            screen, faces, attrs = hull_scene(5, size=1024)
        else:
            screen = np.zeros((3, 3), np.float32)
            faces = np.zeros((256, 3), np.int32)
            attrs = np.ones((16, 256), np.float32)
        s, f, a = t(screen).to(dev), t(faces).to(dev), t(attrs).to(dev)
        tri, inv = tc.face_rows(s, f)
        n = faces.shape[0]
        staged = tc.bin_faces_banded(
            tc.face_table(tri, a, inv), *tc.face_bboxes(tri), inv != 0.0,
            1024, 1024, 256, tc.BAND_H, min(tc.BAND_CAP, n),
            min(tc.BIN_CAP, n))
        got = tc.raster_banded(*staged, 1024, 1024, 256, tc.BAND_H)
        want = tc.raster_banded_plain(*staged, 1024, 1024, 256, tc.BAND_H)
        flat = tc.raster_flat(tri, inv, a, 1024, 1024)
        torch.cuda.synchronize()
        for g, w_, fl in zip(got, want, flat):
            assert torch.equal(g, fl)
            if g.dtype == torch.int32 or g.dim() == 3:
                assert torch.equal(g, w_)
            else:
                assert float((g - w_).abs().max()) <= 1e-5
        if case == "empty":
            assert (got[0] == -1).all() and (got[3] == 0).all()
