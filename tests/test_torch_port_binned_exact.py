"""The binned rasterizer's exact overflow path (B1), the render below 1024 px.

With the unclipped tile counts and the full face table, ``raster_binned``
draws a tile above its capacity from its kept slots (the lowest ids) and
then the table's faces after them, so its result equals the flat
kernel's on every frame. These tests hold the plain version of that path
against ``raster_flat_plain`` bit for bit (fid, barycentrics and
attribute planes) on scenes that fit, with one and with several tiles
above the cap, and with NaN vertices; ``render_hands`` against JAX's
``render_hands(..., backend="pallas", interpret=True)`` on a frame where
JAX takes a binned tier and one where it takes the flat kernel (RGBA to
1e-5, as in tests/test_torch_port_raster.py). The CUDA kernel runs only
on a card: the last test holds it to its plain version and to
``raster_flat`` there and skips on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acr_tpu.viz import raster as jraster
from acr_tpu_torch.viz import raster as traster
from acr_tpu_torch.viz import raster_cuda as tc
from test_torch_port_raster import (
    hull_scene,
    jax_tier,
    t,
    tile_scene,
    two_hand_scene,
)

torch.set_num_threads(2)


def stacked_tiles(counts, size=128):
    """``tile_scene`` repeated down the frame: ``counts[k]`` small
    triangles inside row tile 2k, each copy from its own seed."""
    screens, faces, base = [], [], 0
    for k, n in enumerate(counts):
        s, f = tile_scene(n, size=size, seed=10 + k)
        s = s.copy()
        s[:, 1] += 16 * k
        screens.append(s)
        faces.append(f[:n] + base)
        base += len(s)
    faces = np.concatenate(faces)
    faces = np.concatenate(
        [faces, np.zeros(((-len(faces)) % 128, 3), np.int32)])
    return np.concatenate(screens), faces


def nan_tiles():
    """700 triangles in one tile, three of them with a NaN vertex (one
    kept below the cap of 512, two after it)."""
    screen, faces = tile_scene(700, seed=5)
    for f in (40, 530, 690):
        screen[faces[f, 0]] = np.nan
    return screen, faces


def scene(name):
    """(screen, faces, attrs, size, cap, tiles above the cap)."""
    rng = np.random.RandomState(11)
    if name == "tiles_fit":
        screen, faces = stacked_tiles([300, 200, 450, 500])
        size, cap, over = 128, 512, 0
    elif name == "hulls":                 # two dense meshes, overlapping
        screen, faces, _ = hull_scene(1)
        size, cap, over = 128, 512, 2
    elif name == "one_tile_600":
        screen, faces = tile_scene(600)
        size, cap, over = 128, 512, 1
    elif name == "one_tile_900":
        screen, faces = tile_scene(900, seed=4)
        size, cap, over = 128, 512, 1
    elif name == "several_tiles":
        screen, faces = stacked_tiles([650, 300, 880, 720], size=256)
        size, cap, over = 256, 512, 3
    else:
        screen, faces = nan_tiles()
        size, cap, over = 128, 512, 1
    attrs = rng.randn(16, faces.shape[0]).astype(np.float32)
    return screen, faces, attrs, size, cap, over


def assert_bits_equal(got, want):
    fid_g, bary_g, attr_g = got
    fid_w, bary_w, attr_w = want
    assert torch.equal(fid_g, fid_w)
    for g, w in zip(bary_g, bary_w):
        assert torch.equal(g, w)
    assert torch.equal(attr_g, attr_w)


@pytest.mark.parametrize("name", ["tiles_fit", "hulls", "one_tile_600",
                                  "one_tile_900", "several_tiles",
                                  "nan_vertex"])
def test_exact_binned_plain_equals_flat(name):
    screen, faces, attrs, size, cap, over = scene(name)
    s, f, a = t(screen), t(faces), t(attrs)
    mx, n_over = tc.bin_overflow_stats(s, f, size, size, cap=cap)
    assert int(n_over) == over
    got = tc.rasterize_binned(s, f, size, size, bin_cap=cap, attrs=a,
                              exact=True)
    want = tc.rasterize_flat(s, f, size, size, attrs=a)
    assert_bits_equal(got, want)
    assert int((got[0] >= 0).sum()) > 100
    if over:
        # faces past the cap win pixels, which the dropping path loses
        assert int((got[0] >= cap).sum()) > 0
        dropped = tc.rasterize_binned(s, f, size, size, bin_cap=cap, attrs=a)
        assert not torch.equal(dropped[0], got[0])
    if name == "nan_vertex":
        tri, _ = tc.face_rows(s, f)
        nan_faces = torch.nonzero(torch.isnan(tri[:6]).any(dim=0))[:, 0]
        assert nan_faces.tolist() == [40, 530, 690]
        assert not torch.isin(got[0], nan_faces).any()


@pytest.mark.parametrize("cap", [128, 256])
def test_exact_binned_plain_small_caps(cap):
    """Hulls over two column tiles at 64 x 512 px: at caps 128 and 256
    many tiles overflow, and the result is still the flat one."""
    screen, faces, attrs = hull_scene(0)
    screen[:, 0] *= 4.0
    s, f, a = t(screen), t(faces), t(attrs)
    _, n_over = tc.bin_overflow_stats(s, f, 64, 512, cap=cap)
    assert int(n_over) >= 1
    got = tc.rasterize_binned(s, f, 64, 512, bin_cap=cap, attrs=a, exact=True)
    assert_bits_equal(got, tc.rasterize_flat(s, f, 64, 512, attrs=a))


def test_prestage_counts_are_the_overflow_stats():
    """``bin_faces`` counts every face that reaches a tile, above the cap
    too: the counts ``bin_overflow_stats`` reduces, which the kernel
    reads to find its overflowing tiles."""
    screen, faces = stacked_tiles([650, 300, 880, 720], size=256)
    s, f = t(screen), t(faces)
    tri, inv = tc.face_rows(s, f)
    table = tc.face_table(tri, torch.zeros(16, f.shape[0]), inv)
    tri_t, inv_t, ids_t, counts = tc.bin_faces(table, inv, 256, 256, 256, 512)
    mx, n_over = tc.bin_overflow_stats(s, f, 256, 256, cap=512)
    assert int(counts.max()) == int(mx) == 880
    assert int((counts > 512).sum()) == int(n_over) == 3
    # a tile above the cap keeps its 512 lowest ids, all live
    over = counts > 512
    assert (ids_t[over] >= 0).all() and (inv_t[over] != 0).all()
    assert (ids_t[over].diff(dim=1) > 0).all()


@pytest.mark.parametrize("dist,tier", [(0.4, 256), (2.5, None)])
def test_render_hands_matches_jax_at_256(dist, tier):
    """One frame on which JAX takes the binned tier 256, one on which it
    takes the flat kernel: the port's single binned path gives JAX's
    RGBA on both."""
    size = 256
    verts, cam_trans, det, faces = two_hand_scene(size, dist=dist)
    kw = dict(size=size, focal=1265.0 * size / 512)
    args = (t(verts), t(cam_trans), t(det), t(faces.astype(np.int64)))
    screen, all_faces, _ = traster.prepare_scene(*args, **kw)
    mx, _ = tc.bin_overflow_stats(screen, all_faces, size, size)
    assert jax_tier(int(mx), all_faces.shape[0]) == tier
    want = jraster.render_hands(jnp.asarray(verts), jnp.asarray(cam_trans),
                                jnp.asarray(det), jnp.asarray(faces),
                                backend="pallas", interpret=True, **kw)
    got = traster.render_hands(*args, **kw)
    assert (got[..., 3] > 0).sum() > 50
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_render_below_1024_takes_the_exact_binned_path(monkeypatch):
    """Below 1024 px every frame, even one above every tier, goes to
    ``rasterize_binned`` with ``exact=True``: no tier is chosen, so
    nothing is read to the host."""
    calls = []
    real = traster.rasterize_binned

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(traster, "rasterize_binned", spy)
    monkeypatch.setattr(traster, "rasterize_flat", None)
    monkeypatch.setattr(traster, "banded_fits", None)
    verts, cam_trans, det, faces = two_hand_scene(128, dist=2.5)
    args = (t(verts), t(cam_trans), t(det), t(faces.astype(np.int64)))
    rgba = traster.render_hands(*args, size=128, focal=1265.0 * 128 / 512)
    assert len(calls) == 1 and calls[0]["exact"] is True
    assert calls[0]["bin_cap"] == tc.BIN_CAP
    assert (rgba[..., 3] > 0).sum() > 50


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [128, 512])
def test_cuda_exact_binned_kernel_matches_plain_and_flat(cap):
    """The kernel with overflow against its plain version and against
    ``raster_flat``, bit for bit, on every scene above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for name in ("tiles_fit", "hulls", "one_tile_600", "one_tile_900",
                 "several_tiles", "nan_vertex"):
        screen, faces, attrs, size, _, _ = scene(name)
        s, f, a = (t(x).to(dev) for x in (screen, faces, attrs))
        tri, inv = tc.face_rows(s, f)
        table = tc.face_table(tri, a, inv)
        col_tile = min(tc.COL_TILE, size)
        c = min(cap, f.shape[0])
        staged = tc.bin_faces(table, inv, size, size, col_tile, c)
        before = tc.LAUNCHES["raster_binned"]
        got = tc.raster_binned(staged[3], *staged[:3], size, size, col_tile,
                               table=table)
        want = tc.raster_binned_plain(staged[3], *staged[:3], size, size,
                                      col_tile, table=table)
        flat = tc.raster_flat(tri, inv, a, size, size)
        torch.cuda.synchronize()
        assert tc.LAUNCHES["raster_binned"] == before + 1
        for g, w, fl in zip(got, want, flat):
            assert torch.equal(g, w) and torch.equal(g, fl), name
