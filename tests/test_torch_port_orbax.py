"""The port reads and writes orbax checkpoint directories without orbax.

``acr_tpu_torch.io.orbax`` against ``acr_tpu.io.params``'s orbax
functions (orbax 0.11 through tensorstore), bit for bit: what JAX writes
(OCDBT with zstd) the port reads to the same leaves, what the port
writes (the plain zarr layout) JAX reads to the same leaves, the
committed fixture equals its npz, hand-written multi-chunk zarr arrays
read as tensorstore reads them, corrupt files raise ValueError, and an
orbax ``model_path`` serves the golden weights as the npz does. The same
for zarr v3 (``use_zarr3``): orbax's four layouts, the committed zarr v3
fixtures, hand-built arrays of the codecs orbax does not write here, and
``chip_smoke.py``'s zarr v3 re-encoding against orbax's own.
"""

import ctypes
import ctypes.util
import importlib.util
import json
import os
import random
import shutil
import struct

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


# ---- zarr v3 (orbax's use_zarr3) ----

GOLDEN = os.path.join(HERE, "golden")
ZARR3_FIXTURES = ("orbax_small_zarr3", "orbax_sharded_zarr3")


def _load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# orbax's zarr v3 writer (save_zarr3) and the sharded leaf of the fixture
# script; chip_smoke.py's zarr v3 re-encoding of the port's directory
mk = _load_module("make_orbax_fixture",
                  os.path.join(GOLDEN, "make_orbax_fixture.py"))
chip_smoke = _load_module("chip_smoke",
                          os.path.join(HERE, "..", "chip_smoke.py"))


@pytest.mark.parametrize("compression", [True, False])
@pytest.mark.parametrize("ocdbt", [True, False])
@pytest.mark.parametrize("kind", ["types", "big"])
def test_jax_writes_zarr3_port_reads(tmp_path, kind, ocdbt, compression):
    tree = _tree(kind)
    if kind == "big":           # four shards of (16, 8) over 2 devices
        tree["sharded"] = mk.sharded_leaf()
    path = str(tmp_path / "ckpt")
    mk.save_zarr3(path, tree, use_ocdbt=ocdbt, use_compression=compression)
    meta = json.load(open(os.path.join(path, "_METADATA")))
    assert meta["use_zarr3"] and meta["use_ocdbt"] == ocdbt
    # JAX's load_params takes the directory through orbax
    _assert_same_leaves(tparams.load_params_orbax(path),
                        jparams.load_params(path))
    if kind == "big":
        keys = [k for k in torbax.OcdbtStore(path).items()] if ocdbt else [
            os.path.relpath(os.path.join(d, f), path).encode()
            for d, _, fs in os.walk(path) for f in fs]
        shards = sorted(k for k in keys if k.startswith(b"sharded/c/"))
        assert shards == [f"sharded/c/{i}/0".encode() for i in range(4)]
        kernel = b"backbone.stem.kernel/c/0/0/0/0"
        if ocdbt:               # a value in a data file, not inline
            assert not isinstance(torbax.OcdbtStore(path).items()[kernel],
                                  bytes)


@pytest.mark.parametrize("name", ZARR3_FIXTURES)
def test_committed_zarr3_fixture_equals_npz(name):
    root = os.path.join(GOLDEN, name)
    got = tparams.flatten_params(tparams.load_params_orbax(root))
    with np.load(root + ".npz") as z:
        bf16 = set(z["bfloat16_leaves"].tolist())
        want = {k: z[k] for k in z.files if k != "bfloat16_leaves"}
    assert sorted(got) == sorted(want) and bf16 == {"half"}
    for k, w in want.items():
        g = _bits(got[k])[1] if k in bf16 else got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    meta = json.load(open(os.path.join(root, "_METADATA")))
    assert meta["use_zarr3"]
    if meta["use_ocdbt"]:
        items = torbax.OcdbtStore(root).items()
        assert isinstance(items[b"params.scale/c"], bytes)         # inline
        assert not isinstance(items[b"params.big.kernel/c/0/0"], bytes)
    else:
        assert sorted(os.listdir(os.path.join(
            root, "params.sharded", "c"))) == ["0", "1", "2", "3"]
    _assert_same_leaves(tparams.load_params_orbax(root),
                        jparams.load_params_orbax(root))


def _crc32c_bitwise(data):
    """crc32c bit by bit, apart from the port's table."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
    return crc ^ 0xFFFFFFFF


def _encode(arr, codecs, empty=()):
    """``arr`` through a zarr v3 codec list, in encoding order; ``empty``
    names the inner chunks a shard leaves out."""
    data = arr
    for c in codecs:
        name, cfg = c["name"], c.get("configuration", {})
        if name == "transpose":
            data = data.transpose(cfg["order"])
        elif name == "bytes":
            order = ">" if cfg.get("endian") == "big" else "<"
            data = np.ascontiguousarray(
                data, data.dtype.newbyteorder(order)).tobytes()
        elif name == "sharding_indexed":
            data = _encode_shard(data, cfg, empty)
        elif name == "zstd":
            data = _zstd_compress(data)
        elif name == "crc32c":
            data = data + struct.pack("<I", _crc32c_bitwise(data))
        else:
            data = data + b"?"                      # a codec the reader lacks
    return data


def _encode_shard(shard, cfg, empty):
    inner = cfg["chunk_shape"]
    grid = [-(-s // c) for s, c in zip(shard.shape, inner)]
    index = np.full(grid + [2], 2 ** 64 - 1, np.uint64)
    n_index = len(_encode(index, cfg["index_codecs"]))
    start = cfg.get("index_location", "end") == "start"
    body = b""
    for idx in np.ndindex(*grid):
        if idx in empty:
            continue
        lo = [i * c for i, c in zip(idx, inner)]
        part = shard[tuple(slice(a, a + c) for a, c in zip(lo, inner))]
        block = np.full(inner, 7, shard.dtype)      # edges padded, clipped
        block[tuple(slice(0, n) for n in part.shape)] = part
        raw = _encode(block, cfg["codecs"])
        index[idx] = (len(body) + (n_index if start else 0), len(raw))
        body += raw
    head = _encode(index, cfg["index_codecs"])
    return head + body if start else body + head


def _v3_key(encoding, idx):
    cfg = encoding.get("configuration", {})
    if encoding["name"] == "v2":
        return cfg.get("separator", ".").join(map(str, idx)) or "0"
    return cfg.get("separator", "/").join(["c"] + list(map(str, idx)))


LE = {"name": "bytes", "configuration": {"endian": "little"}}
BE = {"name": "bytes", "configuration": {"endian": "big"}}
ONE_BYTE = {"name": "bytes"}
CRC = {"name": "crc32c"}
ZSTD = {"name": "zstd", "configuration": {"level": 3, "checksum": False}}
DEFAULT = {"name": "default"}


def _shard(inner, codecs, location="end", index=(LE, CRC)):
    return {"name": "sharding_indexed", "configuration": {
        "chunk_shape": list(inner), "codecs": list(codecs),
        "index_codecs": list(index), "index_location": location}}


def _transpose(order):
    return {"name": "transpose", "configuration": {"order": list(order)}}


# name: (shape, data_type, chunk_shape, codecs, chunk_key_encoding,
# fill_value, the absent chunk, the first shard's empty inner chunk, whether
# tensorstore opens it); codecs and layouts orbax does not write here
V3_CASES = {
    "inner_2x2_not_dividing": ((7, 9), "float32", (5, 6),
                               [_shard((3, 4), [LE])], DEFAULT, 0.0, None,
                               None, False),
    "empty_inner_chunk": ((6, 8), "int32", (6, 8),
                          [_shard((3, 4), [LE, ZSTD])], DEFAULT, -7, None,
                          (1, 0), True),
    "index_start": ((5, 8), "float32", (4, 4),
                    [_shard((2, 4), [LE], "start")], DEFAULT, 0.0, (1, 1),
                    None, True),
    "big_endian": ((5, 7), "float64", (2, 3), [BE, ZSTD], DEFAULT, 0.0,
                   (2, 0), None, True),
    "big_endian_shard": ((6, 5), "int16", (6, 5),
                         [_shard((3, 5), [BE], index=(BE, CRC))], DEFAULT,
                         0, None, None, True),
    "transpose": ((5, 6, 3), "float32", (4, 4, 2),
                  [_transpose((2, 0, 1)), LE, ZSTD], DEFAULT, 0.0, (1, 0, 1),
                  None, True),
    "transpose_in_shard": ((4, 6, 3), "float32", (4, 6, 3),
                           [_shard((2, 3, 3), [_transpose((1, 0, 2)), LE])],
                           DEFAULT, 0.0, None, (1, 1, 0), True),
    # tensorstore 0.1 fails on a transpose before a shard, which the spec
    # allows: the shard is the transposed chunk, (3, 4, 6) here
    "transpose_before_shard": ((4, 6, 3), "float32", (4, 6, 3),
                               [_transpose((2, 0, 1)),
                                _shard((3, 2, 3), [_transpose((1, 0, 2)),
                                                   LE])],
                               DEFAULT, 0.0, None, None, False),
    "crc32c_chunk": ((6, 4), "uint8", (6, 4),
                     [_shard((3, 4), [ONE_BYTE, CRC])], DEFAULT, 0, None,
                     None, True),
    "v2_keys": ((5, 6), "float32", (2, 3), [_shard((2, 3), [LE])],
                {"name": "v2"}, 0.0, (1, 1), None, True),
    "default_dot_keys": ((5, 6), "uint16", (2, 3), [LE, CRC],
                         {"name": "default",
                          "configuration": {"separator": "."}}, 3, (0, 1),
                         None, True),
    "zero_d": ((), "float32", (), [_shard((), [LE])], DEFAULT, 0.0, None,
               None, True),
    "zero_d_v2_keys": ((), "int8", (), [ONE_BYTE], {"name": "v2"}, 0, None,
                       None, True),
    "nan_fill": ((5, 6), "float32", (3, 3), [_shard((3, 3), [LE])], DEFAULT,
                 "NaN", (1, 0), None, True),
    "hex_fill": ((5, 6), "float32", (3, 3), [LE, CRC], DEFAULT, "0x40490fdb",
                 (0, 1), (), True),
    "bool_empty": ((9,), "bool", (6,), [_shard((2,), [ONE_BYTE])], DEFAULT,
                   True, None, (1,), True),
}


def _v3_fill(fill, dtype):
    if isinstance(fill, str) and fill.startswith("0x"):
        return np.frombuffer(int(fill, 16).to_bytes(dtype.itemsize, "little"),
                             dtype.newbyteorder("<"))[0]
    return np.array(float(fill) if isinstance(fill, str) else fill, dtype)


def _write_v3_case(root, case, every_chunk=False, codecs=None):
    """The case as a one-leaf checkpoint (``params.x``) in the plain
    layout; returns the array a reader must give."""
    shape, dtype, chunks, case_codecs, encoding, fill, absent, empty, _ = \
        V3_CASES[case]
    codecs = case_codecs if codecs is None else codecs
    dt = np.dtype(dtype)
    rng = np.random.RandomState(11)
    if dt.kind == "b":
        full = np.asarray(rng.rand(*shape) > 0.5)
    elif dt.kind in "iu":
        full = np.asarray(rng.randint(0, 100, shape)).astype(dt)
    else:
        full = np.asarray(rng.randn(*shape)).astype(dt)
    want = full.copy()
    name = os.path.join(root, "params.x")
    os.makedirs(name)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        lo = [i * c for i, c in zip(idx, chunks)]
        sl = tuple(slice(a, a + c) for a, c in zip(lo, chunks))
        if idx == absent:
            want[sl] = _v3_fill(fill, dt)
            continue
        block = np.full(chunks, 5, dt)              # edges padded, clipped
        part = full[sl]
        block[tuple(slice(0, n) for n in part.shape)] = part
        gone = {empty} if empty and not any(idx) else set()
        for e in gone:                  # the first shard's empty inner chunk
            inner = codecs[-1]["configuration"]["chunk_shape"]
            elo = [i * c for i, c in zip(e, inner)]
            want[tuple(slice(a, a + c) for a, c in zip(elo, inner))] = \
                _v3_fill(fill, dt)
        f = os.path.join(name, *_v3_key(encoding, idx).split("/"))
        os.makedirs(os.path.dirname(f), exist_ok=True)
        open(f, "wb").write(_encode(block, codecs, gone))
    json.dump({"zarr_format": 3, "node_type": "array", "shape": list(shape),
               "data_type": dtype, "fill_value": fill,
               "chunk_grid": {"name": "regular",
                              "configuration": {"chunk_shape": list(chunks)}},
               "chunk_key_encoding": encoding, "codecs": codecs},
              open(os.path.join(name, "zarr.json"), "w"))
    json.dump({"tree_metadata": {"('params', 'x')": {
        "key_metadata": [{"key": "params", "key_type": 2},
                         {"key": "x", "key_type": 2}],
        "value_metadata": {"value_type": "np.ndarray",
                           "skip_deserialize": False,
                           "write_shape": list(shape)}}},
        "use_ocdbt": False, "use_zarr3": True,
        "store_array_data_equal_to_fill_value": every_chunk,
        "custom_metadata": None},
        open(os.path.join(root, "_METADATA"), "w"))
    return want


@pytest.mark.parametrize("case", sorted(V3_CASES))
def test_zarr3_hand_built(tmp_path, case):
    root = str(tmp_path / "ck")
    want = _write_v3_case(root, case)
    got = tparams.load_params_orbax(root)["params"]["x"]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if V3_CASES[case][-1]:      # the hand-built bytes as tensorstore reads them
        import tensorstore as ts
        arr = ts.open({"driver": "zarr3", "kvstore": {
            "driver": "file", "path": os.path.join(root, "params.x")}},
            open=True).result()
        np.testing.assert_array_equal(arr.read().result(), want)


@pytest.mark.parametrize("case", ["index_start", "empty_inner_chunk",
                                  "bool_empty", "nan_fill"])
def test_zarr3_every_chunk_raises(tmp_path, case):
    # orbax's own checkpoints claim every chunk stored: an absent shard or
    # an empty chunk of a shard raises
    root = str(tmp_path / "ck")
    _write_v3_case(root, case, every_chunk=True)
    with pytest.raises(ValueError, match="is missing"):
        jparams.load_params_orbax(root)
    with pytest.raises(ValueError, match=r"params\.x (inner )?chunk .*: "
                                         "missing"):
        tparams.load_params_orbax(root)


def test_zarr3_bad_index_crc_raises(tmp_path):
    root = str(tmp_path / "ck")
    shutil.copytree(os.path.join(GOLDEN, "orbax_sharded_zarr3"), root)
    f = os.path.join(root, "params.sharded", "c", "2", "0")
    b = bytearray(open(f, "rb").read())
    b[-10] ^= 0x04                                  # the index, not the crc
    open(f, "wb").write(bytes(b))
    with pytest.raises(ValueError, match="crc32c mismatch") as err:
        tparams.load_params_orbax(root)
    assert os.path.join(root, "params.sharded") in str(err.value)


@pytest.mark.parametrize("where", ["array", "shard"])
def test_zarr3_unknown_codec_raises(tmp_path, where):
    gzip = {"name": "gzip", "configuration": {"level": 5}}
    codecs = ([LE, gzip] if where == "array" else
              [_shard((3, 3), [LE, gzip])])
    root = str(tmp_path / "ck")
    _write_v3_case(root, "nan_fill", codecs=codecs)
    with pytest.raises(ValueError, match="codec 'gzip' is not read") as err:
        tparams.load_params_orbax(root)
    assert os.path.join(root, "params.x") in str(err.value)


def test_chip_smoke_zarr3_helper_matches_orbax(tmp_path):
    # chip_smoke.py's re-encoding of the port's directory, judged by orbax:
    # the zarr.json and shard files orbax writes for the same tree
    tree = mk.fixture_tree()
    flat = jparams.flatten_params(tree)
    port = {k: (torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
                if v.dtype == jnp.bfloat16 else v) for k, v in flat.items()}
    v2, mine, theirs = (str(tmp_path / n) for n in ("v2", "mine", "orbax"))
    tparams.save_params_orbax(v2, tparams.unflatten_params(port))
    chip_smoke._zarr3_from_v2(v2, mine)
    mk.save_zarr3(theirs, tree, use_ocdbt=False, use_compression=False)
    for k in flat:
        leaf = "params." + k.replace("/", ".")
        files = [sorted(os.path.relpath(os.path.join(d, f), os.path.join(
            root, leaf)) for d, _, fs in os.walk(os.path.join(root, leaf))
            for f in fs) for root in (mine, theirs)]
        assert files[0] == files[1], k
        for f in files[0]:
            a, b = (open(os.path.join(root, leaf, f), "rb").read()
                    for root in (mine, theirs))
            if f == "zarr.json":
                assert json.loads(a) == json.loads(b), k
            else:
                assert a == b, (k, f)
    _assert_same_leaves(jparams.load_params_orbax(mine), tree)
    _assert_same_leaves(tparams.load_params_orbax(mine), tree)


def test_zarr3_model_path_serves_like_npz(tmp_path):
    # ACRApp on the full-width weights chip_smoke.py serves: from the npz,
    # from the port's directory re-encoded as zarr v3, and from orbax's own
    # zarr v3 OCDBT directory of the same tree
    from acr_tpu_torch.config import Config
    from acr_tpu_torch.pipeline.app import ACRApp
    weights = chip_smoke._weights(3.0)
    npz, v2 = str(tmp_path / "w.npz"), str(tmp_path / "v2")
    tparams.save_params_npz(npz, weights)
    tree = tparams.unflatten_params(tparams.to_flax(weights))
    tparams.save_params_orbax(v2, tree)
    paths = {"npz": npz, "port zarr3": str(tmp_path / "port_zarr3"),
             "orbax zarr3": str(tmp_path / "orbax_zarr3")}
    chip_smoke._zarr3_from_v2(v2, paths["port zarr3"])
    mk.save_zarr3(paths["orbax zarr3"], tree)
    frame = (np.random.RandomState(5).rand(96, 128, 3) * 255).astype(np.uint8)
    outs = {}
    for name, path in paths.items():
        cfg = Config(input_size=128, render_size=128, mano_model_path=MANO_DIR,
                     configs_yml="", centermap_conf_thresh=-1e9,
                     model_path=path, output_dir=str(tmp_path / name) + "/")
        app = ACRApp(cfg, device="cpu")
        app.process_frame(frame, "frame_0.jpg")
        outs[name] = app.last_output
    assert outs["npz"]["detection_flag"].all()
    for name in ("port zarr3", "orbax zarr3"):
        assert sorted(outs[name]) == sorted(outs["npz"])
        for k, v in outs["npz"].items():
            np.testing.assert_array_equal(outs[name][k], v, err_msg=k)
