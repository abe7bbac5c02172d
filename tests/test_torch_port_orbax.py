"""The port reads and writes orbax checkpoint directories without orbax.

``acr_tpu_torch.io.orbax`` against ``acr_tpu.io.params``'s orbax
functions (orbax 0.11 through tensorstore), bit for bit: what JAX writes
(OCDBT with zstd) the port reads to the same leaves, what the port
writes (the plain zarr layout) JAX reads to the same leaves, the
committed fixture equals its npz, hand-written multi-chunk zarr arrays
read as tensorstore reads them, corrupt files raise ValueError, and an
orbax ``model_path`` serves the golden weights as the npz does.
"""

import ctypes
import ctypes.util
import json
import os
import random
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acr_tpu.io import params as jparams
from acr_tpu_torch.io import orbax as torbax
from acr_tpu_torch.io import params as tparams

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(HERE, "golden", "orbax_small")
FIXTURE_NPZ = os.path.join(HERE, "golden", "orbax_small.npz")
MANO_DIR = os.path.join(HERE, "..", "model_data", "mano")


def _bits(x):
    """(dtype name, numpy array of the leaf's exact bits)."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return "bfloat16", x.view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return "bfloat16", a.view(np.uint16)
    return a.dtype.name, a


def _assert_same_leaves(got, want):
    got, want = tparams.flatten_params(got), jparams.flatten_params(want)
    assert sorted(got) == sorted(want)
    for k in want:
        (gd, g), (wd, w) = _bits(got[k]), _bits(want[k])
        assert gd == wd, k
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _tree(kind):
    rng = np.random.RandomState(7)
    if kind == "types":        # fp32, bf16, int8, 0-d and 4-D leaves
        return {"params": {
            "conv": {"kernel": rng.randn(3, 3, 4, 5).astype(np.float32)},
            "w": rng.randn(6, 4).astype(np.float32),
            "h": jnp.asarray(rng.randn(3, 5), jnp.bfloat16),
            "q": rng.randint(-128, 128, (4, 3)).astype(np.int8),
            "s": np.float32(-2.25)}}
    # big leaves (chunks in the data files, not inline), bool and int32,
    # no 'params' wrapper (both packages add it)
    return {"backbone": {"stem": {"kernel": rng.randn(3, 3, 16, 32).astype(
        np.float32), "bias": rng.randn(32).astype(np.float32)}},
            "mask": rng.rand(11) > 0.5,
            "ids": np.arange(24, dtype=np.int32).reshape(2, 3, 4)}


@pytest.mark.parametrize("kind", ["types", "big"])
def test_jax_writes_port_reads(tmp_path, kind):
    path = str(tmp_path / "ckpt")
    jparams.save_params_orbax(path, _tree(kind))
    assert json.load(open(os.path.join(path, "_METADATA")))["use_ocdbt"]
    assert os.path.exists(os.path.join(path, "manifest.ocdbt"))
    _assert_same_leaves(tparams.load_params_orbax(path),
                        jparams.load_params_orbax(path))


@pytest.mark.parametrize("kind", ["types", "big"])
def test_port_writes_jax_reads(tmp_path, kind):
    tree = _tree(kind)
    want = jparams.unflatten_params(jparams.flatten_params(tree))
    port_tree = {k: (torch.from_numpy(np.asarray(v).view(np.int16).copy())
                     .view(torch.bfloat16) if np.asarray(v).dtype ==
                     jnp.bfloat16 else np.asarray(v))
                 for k, v in jparams.flatten_params(tree).items()}
    path = str(tmp_path / "ckpt")
    tparams.save_params_orbax(path, tparams.unflatten_params(port_tree))
    assert not json.load(open(os.path.join(path, "_METADATA")))["use_ocdbt"]
    _assert_same_leaves(jparams.load_params_orbax(path), want)


def test_port_writes_and_reads_its_own(tmp_path):
    tree = jparams.flatten_params(_tree("big"))
    path = str(tmp_path / "ckpt")
    # an old checkpoint (here JAX's OCDBT one) is replaced whole
    jparams.save_params_orbax(path, _tree("types"))
    tparams.save_params_orbax(path, tparams.unflatten_params(tree))
    got = tparams.flatten_params(tparams.load_params_orbax(path))
    assert sorted(got) == sorted(tree)
    for k in tree:
        assert got[k].dtype == tree[k].dtype
        np.testing.assert_array_equal(got[k], tree[k], err_msg=k)
    assert not os.path.exists(os.path.join(path, "manifest.ocdbt"))
    assert os.listdir(tmp_path) == ["ckpt"]      # no temporary left beside


def test_committed_fixture_equals_npz():
    got = tparams.flatten_params(tparams.load_params_orbax(FIXTURE_DIR))
    with np.load(FIXTURE_NPZ) as z:
        bf16 = set(z["bfloat16_leaves"].tolist())
        want = {k: z[k] for k in z.files if k != "bfloat16_leaves"}
    assert sorted(got) == sorted(want) and bf16 == {"half"}
    for k, w in want.items():
        g = _bits(got[k])[1] if k in bf16 else got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    # the fixture's big chunk is a value in a process data file
    ref = torbax.OcdbtStore(FIXTURE_DIR).items()[b"params.big.kernel/0.0"]
    assert ref[0].startswith(
        os.path.join(FIXTURE_DIR, "ocdbt.process_0", "d") + os.sep)
    _assert_same_leaves(tparams.load_params_orbax(FIXTURE_DIR),
                        jparams.load_params_orbax(FIXTURE_DIR))


def _zstd_compress(data: bytes) -> bytes:
    lib = ctypes.CDLL(ctypes.util.find_library("zstd"))
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_compress.restype = ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_int]
    cap = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.ZSTD_compress(out, cap, data, len(data), 3)
    return out.raw[:n]


# (shape, chunks, order, separator, compressed, dtype, fill value, the chunk
# left absent): edge chunks cropped, absent chunks filled where the
# checkpoint does not claim every chunk stored
MULTI_CHUNK = {
    "c_dot_raw_f4": ((5, 7), (2, 3), "C", ".", False, "<f4", None, (1, 2)),
    "f_slash_zstd_be": ((5, 7), (2, 3), "F", "/", True, ">f4", 1.5, (2, 0)),
    "c_zstd_i1_3d": ((4, 4, 3), (3, 3, 2), "C", ".", True, "|i1", -1,
                     (1, 0, 1)),
    "f_raw_b1": ((9,), (4,), "F", ".", False, "|b1", True, (1,)),
}


@pytest.mark.parametrize("every_chunk", [False, True])
@pytest.mark.parametrize("case", sorted(MULTI_CHUNK))
def test_multi_chunk_plain_layout(tmp_path, case, every_chunk):
    shape, chunks, order, sep, zstd, dtype, fill, absent = MULTI_CHUNK[case]
    rng = np.random.RandomState(3)
    dt = np.dtype(dtype)
    if dt.kind == "b":
        full = rng.rand(*shape) > 0.5
    elif dt.kind == "i":
        full = rng.randint(-100, 100, shape).astype(dt)
    else:
        full = rng.randn(*shape).astype(dt)
    want = full.copy()
    name = "params.x"
    os.makedirs(tmp_path / "ck" / name)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        lo = [i * c for i, c in zip(idx, chunks)]
        sl = tuple(slice(a, a + c) for a, c in zip(lo, chunks))
        if idx == absent:
            want[sl] = fill if fill is not None else 0
            continue
        block = np.zeros(chunks, dt)                  # edge chunks padded
        part = full[sl]
        block[tuple(slice(0, n) for n in part.shape)] = part
        raw = block.tobytes(order=order)
        f = tmp_path / "ck" / name / sep.join(map(str, idx))
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_bytes(_zstd_compress(raw) if zstd else raw)
    zarray = {"chunks": list(chunks), "compressor":
              {"id": "zstd", "level": 3} if zstd else None,
              "dimension_separator": sep, "dtype": dtype, "fill_value": fill,
              "filters": None, "order": order, "shape": list(shape),
              "zarr_format": 2}
    (tmp_path / "ck" / name / ".zarray").write_text(json.dumps(zarray))
    (tmp_path / "ck" / "_METADATA").write_text(json.dumps({
        "tree_metadata": {"('params', 'x')": {
            "key_metadata": [{"key": "params", "key_type": 2},
                             {"key": "x", "key_type": 2}],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False,
                               "write_shape": list(shape)}}},
        "use_ocdbt": False, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": every_chunk,
        "custom_metadata": None}))
    if every_chunk:       # orbax's own checkpoints: a missing chunk raises
        with pytest.raises(ValueError, match="is missing"):
            jparams.load_params_orbax(str(tmp_path / "ck"))
        with pytest.raises(ValueError, match="chunk .* missing"):
            tparams.load_params_orbax(str(tmp_path / "ck"))
        return
    got = tparams.load_params_orbax(str(tmp_path / "ck"))["params"]["x"]
    jax_got = np.asarray(jparams.load_params_orbax(
        str(tmp_path / "ck"))["params"]["x"])
    np.testing.assert_array_equal(jax_got, want)        # tensorstore's view
    assert got.dtype == dt.newbyteorder("=") and got.shape == shape
    np.testing.assert_array_equal(got, want)


def _corrupt(root, how):
    """Damage the copy of the fixture at ``root``; returns the file."""
    node = os.path.join(root, "d", os.listdir(os.path.join(root, "d"))[0])
    if how == "manifest_byte":
        f = os.path.join(root, "manifest.ocdbt")
        b = bytearray(open(f, "rb").read())
        b[40] ^= 0x10
    elif how == "node_byte":
        f = node
        b = bytearray(open(f, "rb").read())
        b[len(b) // 2] ^= 0x01
    elif how == "node_magic":
        f = node
        b = bytearray(open(f, "rb").read())
        b[:4] = b"\x0c\xdb\x3a\x2a"                 # a manifest's magic
    elif how == "manifest_truncated":
        f = os.path.join(root, "manifest.ocdbt")
        b = bytearray(open(f, "rb").read())[:-9]
    else:                                           # the big chunk's file
        f = torbax.OcdbtStore(root).items()[b"params.big.kernel/0.0"][0]
        b = bytearray(open(f, "rb").read())[:1000]
    open(f, "wb").write(bytes(b))
    return f


@pytest.mark.parametrize("how", ["manifest_byte", "node_byte", "node_magic",
                                 "manifest_truncated", "data_truncated"])
def test_corrupt_checkpoint_raises(tmp_path, how):
    root = str(tmp_path / "ck")
    shutil.copytree(FIXTURE_DIR, root)
    f = _corrupt(root, how)
    with pytest.raises(ValueError) as err:
        tparams.load_params_orbax(root)
    assert f in str(err.value)


def test_missing_key_raises(tmp_path):
    root = str(tmp_path / "ck")
    shutil.copytree(FIXTURE_DIR, root)
    meta_path = os.path.join(root, "_METADATA")
    meta = json.load(open(meta_path))
    meta["tree_metadata"]["('params', 'ghost')"] = {
        "key_metadata": [{"key": "params", "key_type": 2},
                         {"key": "ghost", "key_type": 2}],
        "value_metadata": {"value_type": "jax.Array",
                           "skip_deserialize": False, "write_shape": [2]}}
    json.dump(meta, open(meta_path, "w"))
    with pytest.raises(ValueError, match="no key params.ghost/.zarray"):
        tparams.load_params_orbax(root)


def test_missing_zstd_raises(monkeypatch):
    monkeypatch.setattr(torbax, "_zstd", None)
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    with pytest.raises(RuntimeError, match="libzstd not found"):
        tparams.load_params_orbax(FIXTURE_DIR)


def test_btree_walk_equals_tensorstore(tmp_path):
    # interior nodes (small node limit), indirect and inline values, zstd
    # and plain nodes, several generations: every key and value as
    # tensorstore reads them
    import tensorstore as ts
    rng = random.Random(0)
    for t, (node_bytes, inline, zstd) in enumerate(
            [(200, 16, True), (400, 0, False), (100000, 1024, True)]):
        root = str(tmp_path / f"kv{t}")
        cfg = {"max_decoded_node_bytes": node_bytes,
               "max_inline_value_bytes": inline}
        if zstd:
            cfg["compression"] = {"id": "zstd"}
        kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}",
                              "config": cfg}).result()
        for _ in range(2):
            with ts.Transaction() as txn:
                for i in range(120):
                    key = f"params.layer{rng.randrange(60):03d}/k/{i % 3}.0"
                    kv.with_transaction(txn)[key] = bytes(
                        rng.randrange(256) for _ in range(rng.randrange(90)))
        want = {k: kv.read(k).result().value for k in kv.list().result()}
        store = torbax.OcdbtStore(root)
        got = {k: store.read(v) for k, v in store.items().items()}
        assert sorted(got) == sorted(want), t
        assert all(got[k] == want[k] for k in want), t


def test_orbax_model_path_serves_like_npz(tmp_path):
    from acr_tpu.models.acr import ACRNet as JaxACRNet
    from acr_tpu_torch.config import Config
    from acr_tpu_torch.pipeline.infer import ACRPipeline
    params = JaxACRNet().init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 64, 3), jnp.uint8))
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 0.2 if getattr(p[-1], "key", None) == "scale" else x,
        params)
    npz = str(tmp_path / "golden.npz")
    jparams.save_params_npz(npz, params)
    jax_dir, port_dir = str(tmp_path / "jax_orbax"), str(tmp_path / "port")
    jparams.save_params_orbax(jax_dir, params)
    tparams.save_params_orbax(port_dir, tparams.load_params_npz(npz))
    rng = np.random.RandomState(42)
    img = (rng.rand(1, 128, 128, 3) * 255).astype(np.uint8)
    off = np.array([[128, 128, 0, 0, 0, 0, 0, 0, 0, 0]], np.float32)
    outs = {}
    for name, path in (("npz", npz), ("jax orbax", jax_dir),
                       ("port orbax", port_dir)):
        cfg = Config(input_size=128, mano_model_path=MANO_DIR, configs_yml="",
                     model_path=path)
        outs[name] = ACRPipeline(cfg, device="cpu")(img, off)
    for name in ("jax orbax", "port orbax"):
        assert outs[name].keys() == outs["npz"].keys()
        for k, v in outs["npz"].items():
            assert torch.equal(outs[name][k], v), (name, k)
