"""Orbax checkpoint directories, read and written without orbax.

``acr_tpu.io.params.save_params_orbax`` saves a params tree with orbax's
``PyTreeCheckpointer``. Its directory is plain bytes on disk:

* ``_METADATA``: JSON. ``tree_metadata`` maps each leaf's key path to
  its ``key_metadata`` (the dict keys) and ``value_metadata``;
  ``use_ocdbt`` says where the arrays are, ``use_zarr3`` which zarr
  version they are. Each leaf is one zarr array named by its keys joined
  with '.' (``params.a.w``).
* ``use_ocdbt: false``: each array is a directory, ``<name>/.zarray``
  (JSON) and one file per chunk (``<name>/0.0``); in zarr v3,
  ``<name>/zarr.json`` and ``<name>/c/0/0``.
* ``use_ocdbt: true`` (orbax's default): the same keys
  (``params.a.w/.zarray``, ``params.a.w/0.0``) live in an OCDBT
  key-value store, tensorstore's b-tree on files. ``manifest.ocdbt``
  names the versions and their root nodes; the nodes and the values sit
  in data files (``d/<hex>``, ``ocdbt.process_0/d/<hex>``).
* zarr v3 (orbax's ``use_zarr3=True``): each chunk goes through a codec
  chain. Orbax writes one ``sharding_indexed`` codec: the chunk is a
  shard of inner chunks (``bytes``, then ``zstd`` where compressed) and
  an index of one (offset, nbytes) u64 pair per inner chunk, encoded by
  ``bytes`` and ``crc32c``. ``transpose``, both byte orders, the
  ``default`` and ``v2`` chunk keys, an index at the shard's start and
  empty inner chunks are read too; any other codec raises ValueError
  naming it.

Every OCDBT file (a manifest, or a b-tree node at an offset of a data
file) has one frame: a big-endian u32 magic, the u64 little-endian
length of the frame, a varint version (0), a varint compression
(0 none, 1 zstd), the body, and a little-endian crc32c of everything
before it. The bodies are varints and arrays of varints; keys are
prefix-compressed. A bad magic, length, crc, key or value raises
ValueError naming the file.

zstd frames (OCDBT bodies and zarr chunks) are decompressed by the
system's libzstd through ctypes; where it is missing, reading raises.
``save_orbax`` writes the ``use_ocdbt: false`` layout of zarr v2 arrays
with uncompressed chunks, which orbax reads as it reads its own. Host
numpy only.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import math
import os
import shutil
import struct
import threading
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"
METADATA = "_METADATA"
ZARR2_META, ZARR3_META = ".zarray", "zarr.json"
_MISSING = 2 ** 64 - 1            # a root location's offset in an empty tree
_DICT_KEY = 2                     # orbax's key_type of a dict key
_VALUE_TYPES = ("jax.Array", "np.ndarray", "scalar")

# --- crc32c (Castagnoli, reflected), table-driven -------------------------


def _crc32c_table() -> List[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# --- zstd through the system library ---------------------------------------

_zstd = None
_zstd_lock = threading.Lock()
_UNKNOWN_SIZE = 2 ** 64 - 1
_SIZE_ERROR = 2 ** 64 - 2


def zstd_library() -> ctypes.CDLL:
    """The system's libzstd, loaded once. Raises RuntimeError where it is
    missing: no checkpoint is read without it."""
    global _zstd
    if _zstd is not None:
        return _zstd
    with _zstd_lock:
        if _zstd is None:
            name = ctypes.util.find_library("zstd")
            if name is None:
                raise RuntimeError(
                    "libzstd not found (ctypes.util.find_library('zstd')): "
                    "reading an orbax checkpoint needs the system's zstd "
                    "library (libzstd.so.1)")
            lib = ctypes.CDLL(name)
            lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
            lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p,
                                                     ctypes.c_size_t]
            lib.ZSTD_decompress.restype = ctypes.c_size_t
            lib.ZSTD_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                            ctypes.c_char_p, ctypes.c_size_t]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
            lib.ZSTD_getErrorName.restype = ctypes.c_char_p
            lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
            lib.ZSTD_versionNumber.restype = ctypes.c_uint
            lib.ZSTD_versionNumber.argtypes = []
            _zstd = lib
    return _zstd


def zstd_decompress(data: bytes, what: str, size: Optional[int] = None
                    ) -> bytes:
    """Decompress the zstd frame(s) ``data`` to ``size`` bytes (a zarr
    chunk's), or to the content size the frame records; where it records
    none (tensorstore streams large OCDBT nodes), into a buffer doubled
    until the frame fits."""
    lib = zstd_library()
    if size is None:
        size = lib.ZSTD_getFrameContentSize(data, len(data))
        if size == _SIZE_ERROR:
            raise ValueError(f"{what}: not a zstd frame")
    grow = size == _UNKNOWN_SIZE
    cap = max(4 * len(data), 1 << 16) if grow else size
    while True:
        out = ctypes.create_string_buffer(max(cap, 1))
        n = lib.ZSTD_decompress(out, cap, data, len(data))
        if not lib.ZSTD_isError(n):
            break
        err = lib.ZSTD_getErrorName(n).decode()
        if not (grow and "too small" in err):
            raise ValueError(f"{what}: zstd: {err}")
        cap *= 2
    if not grow and n != size:
        raise ValueError(f"{what}: zstd gave {n} bytes, want {size}")
    return out.raw[:n]


# --- OCDBT -----------------------------------------------------------------


class _Bytes:
    """A cursor over a decoded body; reading past its end raises."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated body")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} "
                             "bytes after the body")


def _frame(data: bytes, magic: int, what: str) -> _Bytes:
    """Check one OCDBT frame (magic, length, crc32c) and return a cursor
    over its decoded body."""
    if len(data) < 18:
        raise ValueError(f"{what}: truncated ({len(data)} bytes)")
    got = struct.unpack(">I", data[:4])[0]
    if got != magic:
        raise ValueError(f"{what}: bad magic {got:#010x}, want {magic:#010x}")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise ValueError(f"{what}: length field {length}, have {len(data)} "
                         "bytes")
    crc = struct.unpack("<I", data[-4:])[0]
    if _crc32c(data[:-4]) != crc:
        raise ValueError(f"{what}: crc32c mismatch")
    head = _Bytes(data[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version}")
    body = head.data[head.pos:]
    if compression == 1:
        body = zstd_decompress(body, what)
    elif compression != 0:
        raise ValueError(f"{what}: compression {compression}")
    return _Bytes(body, what)


def _keys(r: _Bytes, n: int, extra: int = 0
          ) -> Tuple[List[bytes], List[List[int]]]:
    """``n`` prefix-compressed keys: prefix lengths (all but the first),
    suffix lengths, ``extra`` more arrays of n varints, then the suffix
    bytes. Returns (keys, the extra arrays)."""
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    more = [r.varints(n) for _ in range(extra)]
    keys: List[bytes] = []
    for i in range(n):
        if i and prefix[i] > len(keys[-1]):
            raise ValueError(f"{r.what}: bad key prefix length {prefix[i]}")
        key = (keys[-1][:prefix[i]] if i else b"") + r.take(suffix[i])
        if keys and key <= keys[-1]:
            raise ValueError(f"{r.what}: keys out of order at {key!r}")
        keys.append(key)
    return keys, more


class OcdbtStore:
    """Read-only view of the OCDBT key-value store under ``root``."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        path = os.path.join(self.root, MANIFEST)
        r = _frame(self._read(path), MANIFEST_MAGIC, path)
        r.take(16)                                   # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{path}: manifest kind {kind} (numbered "
                             "manifests are not read)")
        r.varint()                                   # max inline value bytes
        self.max_node_bytes = r.varint()
        r.byte()                                     # version tree arity
        if r.varint() == 1:
            r.take(4)                                # zstd level, int32
        files = self._file_table(r)
        n = r.varint()
        gens = r.varints(n)
        heights = [r.byte() for _ in range(n)]
        locs = list(zip(r.varints(n), r.varints(n), r.varints(n)))
        r.varints(3 * n)                             # statistics
        r.take(8 * n)                                # commit times
        if not n:
            raise ValueError(f"{path}: no version")
        newest = max(range(n), key=gens.__getitem__)
        file_id, offset, length = locs[newest]
        self.root_node = (None if offset == _MISSING else
                          (self._file(files, file_id, path), offset, length,
                           heights[newest]))

    def _read(self, path: str) -> bytes:
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError as exc:
            raise ValueError(f"{path}: cannot read: {exc}") from exc

    def _file_table(self, r: _Bytes) -> List[str]:
        """The data files a manifest or node refers to: prefix-compressed
        paths, relative to the store's root."""
        n = r.varint()
        prefix = [0] + r.varints(max(n - 1, 0))
        suffix = r.varints(n)
        r.varints(n)                                 # base path lengths
        paths: List[str] = []
        for i in range(n):
            if i and prefix[i] > len(paths[-1]):
                raise ValueError(f"{r.what}: bad data file prefix")
            paths.append((paths[-1][:prefix[i]] if i else "")
                         + r.take(suffix[i]).decode())
        return paths

    def _file(self, files: List[str], file_id: int, what: str) -> str:
        if file_id >= len(files):
            raise ValueError(f"{what}: data file {file_id} of {len(files)}")
        rel = files[file_id]
        path = os.path.normpath(os.path.join(self.root, rel))
        if os.path.isabs(rel) or not path.startswith(self.root + os.sep):
            raise ValueError(f"{what}: data file {rel!r} outside the store")
        return path

    def _slice(self, path: str, offset: int, length: int, what: str) -> bytes:
        try:
            with open(path, "rb") as f:
                size = os.fstat(f.fileno()).st_size
                if offset + length > size:
                    raise ValueError(f"{what}: {path}[{offset}:"
                                     f"{offset + length}] past its end "
                                     f"({size} bytes)")
                f.seek(offset)
                return f.read(length)
        except OSError as exc:
            raise ValueError(f"{what}: cannot read {path}: {exc}") from exc

    def items(self) -> Dict[bytes, Union[bytes, Tuple[str, int, int]]]:
        """{key: its value, inline bytes or (data file, offset, length)}
        over the newest version; ``read`` reads either."""
        out: Dict[bytes, Union[bytes, Tuple[str, int, int]]] = {}
        if self.root_node is not None:
            path, offset, length, height = self.root_node
            self._walk(path, offset, length, height, b"", out)
        return out

    def read(self, value: Union[bytes, Tuple[str, int, int]]) -> bytes:
        if isinstance(value, bytes):
            return value
        path, offset, length = value
        return self._slice(path, offset, length, f"value at {path}@{offset}")

    def _walk(self, path, offset, length, height, prefix, out) -> None:
        what = f"{path}@{offset}"
        r = _frame(self._slice(path, offset, length, what), NODE_MAGIC, what)
        if r.byte() != height:
            raise ValueError(f"{what}: node height differs from its parent's "
                             f"record ({height})")
        files = self._file_table(r)
        n = r.varint()
        if height == 0:
            keys, _ = _keys(r, n)
            lengths = r.varints(n)
            kinds = r.varints(n)
            n_ref = sum(k == 1 for k in kinds)
            if any(k not in (0, 1) for k in kinds):
                raise ValueError(f"{what}: value kind {kinds}")
            ref_files, ref_offsets = r.varints(n_ref), r.varints(n_ref)
            refs = iter(zip(ref_files, ref_offsets))
            for key, size, kind in zip(keys, lengths, kinds):
                if kind == 0:
                    out[prefix + key] = r.take(size)
                else:
                    fid, off = next(refs)
                    out[prefix + key] = (self._file(files, fid, what), off,
                                         size)
            r.end()
            return
        keys, (common,) = _keys(r, n, extra=1)
        children = list(zip(r.varints(n), r.varints(n), r.varints(n)))
        r.varints(3 * n)                             # statistics
        r.end()
        for key, c, (fid, off, size) in zip(keys, common, children):
            if c > len(key):
                raise ValueError(f"{what}: common prefix longer than key")
            self._walk(self._file(files, fid, what), off, size, height - 1,
                       prefix + key[:c], out)


# --- zarr v2 ----------------------------------------------------------------


def _zarr_dtype(spec, what: str) -> np.dtype:
    if spec == "bfloat16":
        return np.dtype("<u2")           # raw bits; made bf16 by the caller
    if not isinstance(spec, str):
        raise ValueError(f"{what}: structured dtype {spec!r}")
    try:
        return np.dtype(spec)
    except TypeError as exc:
        raise ValueError(f"{what}: dtype {spec!r}") from exc


def _fill(value, spec: str, dtype: np.dtype):
    if value is None:
        return 0
    if isinstance(value, str) and value.startswith("0x"):   # v3: the bits
        bits = int(value, 16).to_bytes(dtype.itemsize, "little")
        return np.frombuffer(bits, dtype.newbyteorder("<"))[0].astype(dtype)
    if isinstance(value, str):            # "NaN", "Infinity", "-Infinity"
        value = float(value)
    if spec == "bfloat16":
        return int(torch.tensor(value, dtype=torch.bfloat16)
                   .view(torch.int16).item()) & 0xFFFF
    return np.array(value).astype(dtype)


def _assemble(shape, chunks, dtype: np.dtype, fill, block: Callable,
              every_chunk: bool) -> np.ndarray:
    """An array of ``shape`` from a regular grid of ``chunks``-shaped
    blocks: ``block(idx)`` returns (its name, the block as an array of
    ``chunks``, or None where it is absent). Blocks at the edge are
    clipped; an absent one leaves the fill value, or raises where
    ``every_chunk``."""
    out = np.full(shape, fill, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        name, data = block(idx)
        if data is None:
            if every_chunk:
                raise ValueError(f"{name}: missing")
            continue
        lo = [i * c for i, c in zip(idx, chunks)]
        hi = [min(a + c, s) for a, c, s in zip(lo, chunks, shape)]
        out[tuple(slice(a, b) for a, b in zip(lo, hi))] = \
            data[tuple(slice(0, b - a) for a, b in zip(lo, hi))]
    return out


def _finish(out: np.ndarray, bf16: bool):
    """Native byte order; the raw bits of a bf16 array as torch.bfloat16."""
    if not out.dtype.isnative:
        out = out.astype(out.dtype.newbyteorder("="))
    if bf16:
        return torch.from_numpy(out.view(np.int16).copy()).view(torch.bfloat16)
    return out


def _decode_zarr(meta: Dict[str, Any],
                 chunk: Callable[[str], Optional[bytes]], what: str,
                 every_chunk: bool = False):
    """A zarr v2 array from its ``.zarray`` dict and a function that
    returns the stored bytes of a chunk key, or None where the chunk is
    absent: then the fill value, unless ``every_chunk`` (a checkpoint
    whose ``_METADATA`` has ``store_array_data_equal_to_fill_value``, on
    which orbax raises for a missing chunk too). Returns a numpy array,
    or a torch.bfloat16 tensor for a ``bfloat16`` array."""
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{what}: zarr_format {meta.get('zarr_format')}")
    if meta.get("filters"):
        raise ValueError(f"{what}: filters {meta['filters']} are not read")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c < 1 for c in chunks):
        raise ValueError(f"{what}: chunks {chunks} for shape {shape}")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ValueError(f"{what}: order {order!r}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{what}: compressor {comp.get('id')!r} is not read")
    sep = meta.get("dimension_separator", ".")
    dtype = _zarr_dtype(meta["dtype"], what)
    nbytes = math.prod(chunks) * dtype.itemsize

    def block(idx):
        key = sep.join(str(i) for i in idx) if idx else "0"
        ckey = f"{what} chunk {key}"
        raw = chunk(key)
        if raw is None:
            return ckey, None
        data = zstd_decompress(raw, ckey, nbytes) if comp else raw
        if len(data) != nbytes:
            raise ValueError(f"{ckey}: {len(data)} bytes, want {nbytes}")
        return ckey, np.frombuffer(data, dtype).reshape(chunks, order=order)

    out = _assemble(shape, chunks, dtype,
                    _fill(meta.get("fill_value"), meta["dtype"], dtype),
                    block, every_chunk)
    return _finish(out, meta["dtype"] == "bfloat16")


# --- zarr v3 ----------------------------------------------------------------

# data_type -> numpy dtype, native order (the ``bytes`` codec names the
# stored order); bfloat16 as its raw bits, made bf16 by ``_finish``
_V3_DTYPES = {name: np.dtype(name) for name in (
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64")}
_V3_DTYPES["bfloat16"] = np.dtype(np.uint16)
_EMPTY = (_MISSING, _MISSING)             # a shard index's absent chunk


def _codec(c, what: str) -> Tuple[str, Dict[str, Any]]:
    if not isinstance(c, dict) or not isinstance(c.get("name"), str):
        raise ValueError(f"{what}: codec {c!r}")
    cfg = c.get("configuration") or {}
    if not isinstance(cfg, dict):
        raise ValueError(f"{what}: codec {c['name']!r} configuration {cfg!r}")
    return c["name"], cfg


def _split_codecs(codecs, what: str):
    """(array -> array codecs, the array -> bytes codec, bytes -> bytes
    codecs), each as (name, configuration), in encoding order."""
    if not isinstance(codecs, list):
        raise ValueError(f"{what}: codecs {codecs!r}")
    aa, ab, bb = [], None, []
    for c in codecs:
        name, cfg = _codec(c, what)
        if name == "transpose" and ab is None:
            aa.append((name, cfg))
        elif name in ("bytes", "sharding_indexed") and ab is None:
            ab = (name, cfg)
        elif name in ("zstd", "crc32c") and ab is not None:
            bb.append((name, cfg))
        elif name in ("transpose", "bytes", "sharding_indexed", "zstd",
                      "crc32c"):
            raise ValueError(f"{what}: codec {name!r} out of place")
        else:
            raise ValueError(f"{what}: codec {name!r} is not read")
    if ab is None:
        raise ValueError(f"{what}: no bytes or sharding_indexed codec")
    return aa, ab, bb


def _permutation(cfg, ndim: int, what: str) -> List[int]:
    order = cfg.get("order")
    if not isinstance(order, list) or sorted(order) != list(range(ndim)):
        raise ValueError(f"{what}: transpose order {order!r} for {ndim} "
                         "dimensions")
    return order


def _decode_v3(raw, codecs, shape, dtype: np.dtype, fill, what: str,
               every_chunk: bool) -> np.ndarray:
    """One zarr v3 chunk of ``shape`` from its stored bytes, through the
    codec chain: ``transpose``, then ``bytes`` or ``sharding_indexed``,
    then ``zstd`` and ``crc32c``; decoded in the reverse order."""
    aa, (ab, ab_cfg), bb = _split_codecs(codecs, what)
    shapes = [tuple(shape)]
    for _, cfg in aa:
        order = _permutation(cfg, len(shape), what)
        shapes.append(tuple(shapes[-1][i] for i in order))
    nbytes = math.prod(shapes[-1]) * dtype.itemsize
    size = nbytes if ab == "bytes" else None
    sizes = []                            # each bytes codec's input size
    for name, _ in bb:
        sizes.append(size)
        size = None if name == "zstd" or size is None else size + 4
    data = memoryview(raw)
    for (name, _), n in zip(reversed(bb), reversed(sizes)):
        if name == "zstd":
            data = memoryview(zstd_decompress(bytes(data), what, n))
        else:
            if len(data) < 4 or _crc32c(data[:-4]) != \
                    struct.unpack("<I", data[-4:])[0]:
                raise ValueError(f"{what}: crc32c mismatch")
            data = data[:-4]
    if ab == "bytes":
        endian = ab_cfg.get("endian")
        if endian not in ("little", "big") and not (
                endian is None and dtype.itemsize == 1):
            raise ValueError(f"{what}: bytes codec endian {endian!r}")
        if len(data) != nbytes:
            raise ValueError(f"{what}: {len(data)} bytes, want {nbytes}")
        out = np.frombuffer(data, dtype.newbyteorder(
            ">" if endian == "big" else "<")).reshape(shapes[-1])
    else:
        out = _decode_shard(data, ab_cfg, shapes[-1], dtype, fill, what,
                            every_chunk)
    for _, cfg in reversed(aa):
        out = out.transpose(np.argsort(cfg["order"]))
    return out


def _index_bytes(codecs, n: int, what: str) -> int:
    """The stored size of a shard index of ``n`` chunks: only codecs of a
    fixed size (``transpose``, ``bytes``, ``crc32c``) may encode it."""
    _, (ab, _), bb = _split_codecs(codecs, what)
    if ab != "bytes" or any(name != "crc32c" for name, _ in bb):
        raise ValueError(f"{what}: index codecs "
                         f"{[c['name'] for c in codecs]} are not of a "
                         "fixed size")
    return 16 * n + 4 * len(bb)


def _decode_shard(data, cfg, shape, dtype: np.dtype, fill, what: str,
                  every_chunk: bool) -> np.ndarray:
    """A ``sharding_indexed`` shard of ``shape``: a grid of inner chunks,
    each encoded by the inner ``codecs``, located by an index of one
    (offset, nbytes) u64 pair per chunk, in C order, at the shard's end
    (or start)."""
    inner = cfg.get("chunk_shape")
    if (not isinstance(inner, list) or len(inner) != len(shape)
            or any(not isinstance(c, int) or c < 1 for c in inner)):
        raise ValueError(f"{what}: shard chunk_shape {inner!r} for {shape}")
    location = cfg.get("index_location", "end")
    if location not in ("start", "end"):
        raise ValueError(f"{what}: index_location {location!r}")
    grid = [-(-s // c) for s, c in zip(shape, inner)]
    n = _index_bytes(cfg.get("index_codecs"), math.prod(grid),
                     f"{what} shard index")
    if len(data) < n:
        raise ValueError(f"{what}: shard of {len(data)} bytes, index of {n}")
    raw = data[:n] if location == "start" else data[len(data) - n:]
    index = _decode_v3(raw, cfg["index_codecs"], grid + [2],
                       np.dtype(np.uint64), 0, f"{what} shard index",
                       False)

    def block(idx):
        name = f"{what} inner chunk {'.'.join(map(str, idx)) or '0'}"
        offset, nbytes = (int(v) for v in index[idx])
        if (offset, nbytes) == _EMPTY:
            return name, None
        if offset + nbytes > len(data):
            raise ValueError(f"{name}: bytes [{offset}:{offset + nbytes}] "
                             f"past the shard's end ({len(data)})")
        return name, _decode_v3(data[offset:offset + nbytes],
                                cfg.get("codecs"), inner, dtype, fill, name,
                                every_chunk)

    return _assemble(shape, inner, dtype, fill, block, every_chunk)


def _chunk_key(encoding, idx: Tuple[int, ...], what: str) -> str:
    name, cfg = _codec(encoding, what)
    if name == "default":
        sep = cfg.get("separator", "/")
        head = "c"
    elif name == "v2":
        sep = cfg.get("separator", ".")
        head = None
    else:
        raise ValueError(f"{what}: chunk_key_encoding {name!r} is not read")
    if sep not in ("/", "."):
        raise ValueError(f"{what}: chunk key separator {sep!r}")
    parts = [str(i) for i in idx]
    if head is None:
        return sep.join(parts) if parts else "0"
    return sep.join([head] + parts)


def _decode_zarr3(meta: Dict[str, Any],
                  chunk: Callable[[str], Optional[bytes]], what: str,
                  every_chunk: bool = False):
    """A zarr v3 array from its ``zarr.json`` dict and a function that
    returns the stored bytes of a chunk key, or None; an absent chunk, or
    an empty chunk of a shard, takes the fill value unless
    ``every_chunk``, as in ``_decode_zarr``. Returns a numpy array, or a
    torch.bfloat16 tensor for a ``bfloat16`` array."""
    if meta.get("zarr_format") != 3 or meta.get("node_type") != "array":
        raise ValueError(f"{what}: zarr_format {meta.get('zarr_format')} "
                         f"node_type {meta.get('node_type')!r}")
    if meta.get("storage_transformers"):
        raise ValueError(f"{what}: storage_transformers are not read")
    spec = meta["data_type"]
    if not isinstance(spec, str) or spec not in _V3_DTYPES:
        raise ValueError(f"{what}: data_type {spec!r}")
    dtype = _V3_DTYPES[spec]
    grid_name, grid_cfg = _codec(meta["chunk_grid"], what)
    shape, chunks = tuple(meta["shape"]), tuple(grid_cfg.get("chunk_shape", ()))
    if grid_name != "regular" or len(shape) != len(chunks) or any(
            c < 1 for c in chunks):
        raise ValueError(f"{what}: chunk grid {meta['chunk_grid']} for "
                         f"shape {shape}")
    fill = _fill(meta["fill_value"], spec, dtype)

    def block(idx):
        key = _chunk_key(meta.get("chunk_key_encoding", {"name": "default"}),
                         idx, what)
        ckey = f"{what} chunk {key}"
        raw = chunk(key)
        if raw is None:
            return ckey, None
        return ckey, _decode_v3(raw, meta["codecs"], chunks, dtype, fill,
                                ckey, every_chunk)

    return _finish(_assemble(shape, chunks, dtype, fill, block, every_chunk),
                   spec == "bfloat16")


# --- checkpoints -----------------------------------------------------------


def _read_json(path: str) -> Dict[str, Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as exc:
        raise ValueError(f"{path}: cannot read JSON: {exc}") from exc


def _tree_leaves(path: str) -> Tuple[List[Tuple[str, ...]], bool]:
    """The dict keys of every array leaf, from ``_METADATA``, and whether
    the arrays are zarr v3 (``use_zarr3``)."""
    meta_path = os.path.join(path, METADATA)
    meta = _read_json(meta_path)
    if not isinstance(meta.get("tree_metadata"), dict):
        raise ValueError(f"{meta_path}: no tree_metadata")
    leaves = []
    for name, entry in meta["tree_metadata"].items():
        try:
            keys = [k["key"] if k["key_type"] == _DICT_KEY else None
                    for k in entry["key_metadata"]]
            value_type = entry["value_metadata"]["value_type"]
        except (KeyError, TypeError) as exc:
            raise ValueError(f"{meta_path}: {name}: {exc!r}") from exc
        if any(not isinstance(k, str) or "/" in k or k in ("", ".", "..")
               for k in keys):
            raise ValueError(f"{meta_path}: {name} is not a key path of "
                             "dicts")
        if value_type not in _VALUE_TYPES:
            raise ValueError(f"{meta_path}: {name} has value type "
                             f"{value_type!r}")
        leaves.append(tuple(keys))
    return leaves, bool(meta.get("use_zarr3"))


def load_orbax(path: str) -> Dict[str, Any]:
    """The nested dict of arrays that orbax's ``PyTreeCheckpointer``
    saved in the directory ``path``, OCDBT or not, zarr v2 or v3."""
    path = os.path.abspath(path)
    meta = _read_json(os.path.join(path, METADATA))
    every_chunk = bool(meta.get("store_array_data_equal_to_fill_value"))
    leaves, zarr3 = _tree_leaves(path)
    meta_file, decode = ((ZARR3_META, _decode_zarr3) if zarr3 else
                         (ZARR2_META, _decode_zarr))
    if meta.get("use_ocdbt"):
        store = OcdbtStore(path)
        values = store.items()

        def chunk(name, key):
            value = values.get(f"{name}/{key}".encode())
            return None if value is None else store.read(value)

        def array_meta(name):
            key = f"{name}/{meta_file}"
            value = values.get(key.encode())
            if value is None:
                raise ValueError(f"{path}: no key {key} in the OCDBT store")
            try:
                return json.loads(store.read(value))
            except ValueError as exc:
                raise ValueError(f"{path}: {key}: {exc}") from exc
    else:
        def chunk(name, key):
            f = os.path.join(path, name, *key.split("/"))
            if not os.path.exists(f):
                return None
            with open(f, "rb") as fh:
                return fh.read()

        def array_meta(name):
            return _read_json(os.path.join(path, name, meta_file))

    tree: Dict[str, Any] = {}
    for keys in leaves:
        name = ".".join(keys)
        what = os.path.join(path, name)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        meta = array_meta(name)
        try:
            node[keys[-1]] = decode(
                meta, lambda key, n=name: chunk(n, key), what, every_chunk)
        except (KeyError, TypeError, AttributeError) as exc:
            raise ValueError(f"{what}: {meta_file} {exc!r}") from exc
    return tree


def _zarr_leaf(value) -> Tuple[str, np.ndarray]:
    """(zarr dtype, numpy array of its stored bytes; ``tobytes`` gives
    them in C order)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            return "bfloat16", value.contiguous().view(torch.int16).numpy() \
                .view("<u2")
        value = value.numpy()
    arr = np.asarray(value)
    if arr.dtype.kind not in "biuf":
        raise ValueError(f"dtype {arr.dtype} is not written")
    arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
    return arr.dtype.str, arr


def save_orbax(path: str, leaves: Dict[Tuple[str, ...], Any]) -> None:
    """Write ``{dict keys: array}`` as an orbax checkpoint directory in the
    ``use_ocdbt: false`` layout: ``_METADATA`` in orbax's schema and one
    uncompressed zarr v2 array (one chunk) per leaf. It is built in a
    temporary directory beside ``path`` and renamed onto it, so ``path``
    holds the old checkpoint or the whole new one; an old one is
    replaced."""
    path = os.path.abspath(path.rstrip(os.sep))
    tmp = f"{path}.{uuid.uuid4().hex}.tmp"
    tree_meta = {}
    try:
        os.makedirs(tmp)
        for keys, value in leaves.items():
            dtype, arr = _zarr_leaf(value)
            name = ".".join(keys)
            os.makedirs(os.path.join(tmp, name))
            zarray = {"chunks": list(arr.shape), "compressor": None,
                      "dimension_separator": ".", "dtype": dtype,
                      "fill_value": None, "filters": None, "order": "C",
                      "shape": list(arr.shape), "zarr_format": 2}
            with open(os.path.join(tmp, name, ".zarray"), "w") as f:
                json.dump(zarray, f)
            if arr.size:
                key = ".".join("0" for _ in arr.shape) or "0"
                with open(os.path.join(tmp, name, key), "wb") as f:
                    f.write(arr.tobytes())
            tree_meta[str(tuple(keys))] = {
                "key_metadata": [{"key": k, "key_type": _DICT_KEY}
                                 for k in keys],
                "value_metadata": {"value_type": "np.ndarray",
                                   "skip_deserialize": False,
                                   "write_shape": list(arr.shape)}}
        with open(os.path.join(tmp, METADATA), "w") as f:
            json.dump({"tree_metadata": tree_meta, "use_ocdbt": False,
                       "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None}, f)
        old = None
        if os.path.lexists(path):
            old = f"{path}.{uuid.uuid4().hex}.old"
            os.rename(path, old)
        try:
            os.rename(tmp, path)
        except BaseException:
            if old is not None:
                os.rename(old, path)
            raise
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if old is not None:
        if os.path.isdir(old) and not os.path.islink(old):
            shutil.rmtree(old)
        else:
            os.unlink(old)
