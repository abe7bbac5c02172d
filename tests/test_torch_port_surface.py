"""Every public name of acr_tpu has a counterpart in acr_tpu_torch.

An ``ast`` walk lists the public top-level functions and classes of each
module of ``acr_tpu``; each must be a callable of the same name in the
port's module of the same path (the Pallas rasterizers' module maps to
the CUDA kernels' one, ``RENAMED``), or be in ``LEFT_OUT`` with its
reason. So must the public names of ``bench.py`` in ``acr_tpu_torch.bench``
(``SCRIPTS``). The functions ported last are held against JAX's on seeded
inputs: the writers' files, ``load_obj(save_obj(...))``,
``transform_rot_representation`` over every pair of types, ``shade``,
the params helpers and ``native.available``.
"""

import ast
import importlib
import inspect
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acr_tpu.io import params as jparams
from acr_tpu.io import writers as jwriters
from acr_tpu.ops import rotations as jrot
from acr_tpu.viz import raster as jraster
from acr_tpu_torch.io import native as tnative
from acr_tpu_torch.io import params as tparams
from acr_tpu_torch.io import writers as twriters
from acr_tpu_torch.ops import rotations as trot
from acr_tpu_torch.viz import raster as traster

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reasons are ROADMAP's North star: TPU workarounds are not ported
_S2D = ("space-to-depth rewrite for TPU lane occupancy; checkpoints on "
        "disk are canonical and the port builds the canonical network")
_SHARDING = ("a jax.sharding placement; the port's mesh copies the weights "
             "to each replica and splits the batch (parallel/mesh.py)")
_PACK = ("the relay transport's one-buffer readback (arithmetic word pack); "
         "the port reads its outputs back as they are (app.readback)")
LEFT_OUT = {
    "models/s2d.py": _S2D,
    "models/layers.py::space_to_depth2": _S2D,
    "models/layers.py::depth_to_space2": _S2D,
    "models/layers.py::resize_bilinear_x2_s2d": _S2D,
    "models/layers.py::LanePaddedConv": "zero-pads channels to 128 TPU "
    "lanes; the port's convs run at their own widths on cuDNN",
    "models/layers.py::LanePaddedBN": "the folded BN of LanePaddedConv's "
    "padded lanes",
    "models/layers.py::quant_conv": "flax call-site helper that sows amax or "
    "applies the int8 conv; the port swaps QuantConv modules in "
    "(ops/quant.py quantize_modules)",
    "ops/quant.py::observe_clone": "flax clone of ACRNet that sows amax; the "
    "port calibrates with hooks on the float net (ops/quant.py "
    "calibrate_amax)",
    "pipeline/app.py::pack_outputs": _PACK,
    "pipeline/app.py::unpack_outputs": _PACK,
    "parallel/mesh.py::batch_sharding": _SHARDING,
    "parallel/mesh.py::replicated_sharding": _SHARDING,
    "parallel/mesh.py::shard_pipeline_inputs": _SHARDING,
    "viz/raster_pallas.py::bin_cap_for": "returns BIN_CAP at every size (a "
    "TPU VMEM tier list of one); the port's render passes BIN_CAP",
}
# the Pallas kernels' launchers -> the CUDA kernels' wrappers
MODULES = {"viz/raster_pallas.py": "viz/raster_cuda.py"}
RENAMED = {
    "viz/raster_pallas.py::rasterize_pallas": "rasterize_flat",
    "viz/raster_pallas.py::rasterize_pallas_binned": "rasterize_binned",
    "viz/raster_pallas.py::rasterize_pallas_banded": "rasterize_banded",
}


def _jax_modules():
    root = os.path.join(REPO, "acr_tpu")
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
                for f in files if f.endswith(".py")]
    return sorted(out)


def _public(rel, root="acr_tpu"):
    with open(os.path.join(REPO, root, rel)) as f:
        tree = ast.parse(f.read())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")]


def _port_module(rel):
    rel = MODULES.get(rel, rel)
    name = "acr_tpu_torch." + rel[:-3].replace("/", ".")
    return importlib.import_module(name.replace(".__init__", ""))


@pytest.mark.parametrize("rel", _jax_modules())
def test_public_name_has_counterpart(rel):
    names = _public(rel)
    if rel in LEFT_OUT:
        assert not os.path.exists(os.path.join(REPO, "acr_tpu_torch", rel))
        return
    mod = _port_module(rel)
    missing = []
    for name in names:
        key = f"{rel}::{name}"
        if key in LEFT_OUT:
            assert not hasattr(mod, name), f"{key} is ported: drop LEFT_OUT"
            continue
        if not callable(getattr(mod, RENAMED.get(key, name), None)):
            missing.append(name)
    assert not missing, f"{rel}: no counterpart in {mod.__name__}: {missing}"


# the JAX side's scripts at the repository's root -> the port's modules
SCRIPTS = {"bench.py": "acr_tpu_torch.bench"}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_script_has_counterpart(script):
    mod = importlib.import_module(SCRIPTS[script])
    names = _public(script, root="")
    assert names, script
    missing = [n for n in names if not callable(getattr(mod, n, None))]
    assert not missing, f"{script}: no counterpart in {mod.__name__}: " \
        f"{missing}"


def test_left_out_names_exist_in_jax():
    for key in list(LEFT_OUT) + list(RENAMED):
        rel, _, name = key.partition("::")
        assert rel in _jax_modules(), key
        assert not name or name in _public(rel), key


# --- the writers --------------------------------------------------------


def _results():
    rng = np.random.RandomState(0)
    return {"a.jpg": [{"verts": rng.randn(4, 3).astype(np.float32),
                       "hand": 1, "score": np.float32(0.5)}],
            "b.jpg": [], "meta": {"n": np.int64(2), "v": [1.5, 2.0]}}


def _write(mod, kind, path):
    rng = np.random.RandomState(1)
    if kind == "npz":
        return mod.save_npz_results(path, _results())
    if kind == "json":
        return mod.save_json(path, _results())
    if kind == "yaml":
        return mod.save_yaml(path, {"a": 1, "b": [1.5, 2], "c": {"d": "x"}})
    if kind == "obj":
        return mod.save_obj(path, rng.randn(20, 3).astype(np.float32),
                            rng.randint(0, 20, (12, 3)))
    return mod.save_h5(path, {"verts": rng.randn(2, 778, 3).astype(np.float32),
                              "flag": np.array([True, False])})


def _read(kind, path):
    if kind == "npz":
        with np.load(path, allow_pickle=True) as z:
            return repr(z["results"][0])
    if kind == "h5":
        import h5py
        with h5py.File(path, "r") as f:
            return {k: f[k][()] for k in f}
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kind", ["npz", "json", "yaml", "obj", "h5",
                                  "h5_missing"])
def test_writers_write_what_jax_writes(tmp_path, monkeypatch, kind):
    for name in ("save_npz_results", "save_json", "save_yaml", "save_obj",
                 "load_obj", "save_h5"):
        assert inspect.getsource(getattr(twriters, name)) == \
            inspect.getsource(getattr(jwriters, name)), name
    if kind == "h5_missing":
        monkeypatch.setitem(sys.modules, "h5py", None)
        assert twriters.save_h5(str(tmp_path / "t.h5"), {}) is None
        assert jwriters.save_h5(str(tmp_path / "j.h5"), {}) is None
        assert not os.listdir(tmp_path)
        return
    ext = {"npz": ".npz"}.get(kind, "." + kind)
    t, j = str(tmp_path / ("t" + ext)), str(tmp_path / ("j" + ext))
    assert _write(twriters, kind, t) == t
    assert _write(jwriters, kind, j) == j
    got, want = _read(kind, t), _read(kind, j)
    if kind == "h5":
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    else:
        assert got == want
    if kind == "json":
        assert json.loads(got)["a.jpg"][0]["score"] == 0.5


def test_obj_round_trip(tmp_path):
    rng = np.random.RandomState(2)
    verts = rng.randn(778, 3).astype(np.float32)
    faces = rng.randint(0, 778, (1538, 3))
    path = twriters.save_obj(str(tmp_path / "hand.obj"), verts, faces)
    v, f = twriters.load_obj(path)
    jv, jf = jwriters.load_obj(jwriters.save_obj(str(tmp_path / "j.obj"),
                                                 verts, faces))
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert v.dtype == np.float32 and f.dtype == np.int32
    np.testing.assert_array_equal(f, faces)
    np.testing.assert_allclose(v, verts, atol=5e-7)


# --- rotations, shading, params helpers, native query -------------------

ROT_TYPES = ("mat", "quat", "vec", "euler")


def _rots(kind, degrees=False):
    from scipy.spatial.transform import Rotation as R
    r = R.random(6, random_state=5)
    return {"mat": r.as_matrix, "quat": r.as_quat, "vec": r.as_rotvec,
            "euler": lambda: r.as_euler("xyz", degrees=degrees)}[kind]()


@pytest.mark.parametrize("out_type", ROT_TYPES)
@pytest.mark.parametrize("in_type", ROT_TYPES)
def test_transform_rot_representation_equals_jax(in_type, out_type):
    assert inspect.getsource(trot.transform_rot_representation) == \
        inspect.getsource(jrot.transform_rot_representation)
    for degrees in (False, True):
        rot = _rots(in_type, degrees)
        got = trot.transform_rot_representation(rot, in_type, out_type,
                                                euler_degrees=degrees)
        want = jrot.transform_rot_representation(rot, in_type, out_type,
                                                 euler_degrees=degrees)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown out_type"):
        trot.transform_rot_representation(_rots(in_type), in_type, "6d")


def test_shade_equals_jax():
    rng = np.random.RandomState(3)
    h, w, n_faces, n_verts = 24, 32, 40, 30
    face_id = rng.randint(-1, n_faces, (h, w)).astype(np.int32)
    bary = rng.rand(h, w, 3).astype(np.float32)
    bary /= bary.sum(-1, keepdims=True)
    faces = rng.randint(0, n_verts, (n_faces, 3)).astype(np.int32)
    normals = rng.randn(n_verts, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    colors = rng.rand(n_faces, 3).astype(np.float32)
    got = traster.shade(*(torch.from_numpy(a) for a in
                          (face_id, bary, faces, normals, colors)))
    want = np.asarray(jraster.shade(*(
        jnp.asarray(a) for a in (face_id, bary, faces, normals, colors))))
    assert got.shape == (h, w, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[..., 3].numpy(), (face_id >= 0))


@pytest.mark.parametrize("wrapped", [True, False])
def test_flatten_unflatten_params_equal_jax(tmp_path, wrapped):
    rng = np.random.RandomState(4)
    tree = {"backbone": {"stem": {"kernel": rng.randn(3, 3, 3, 8).astype(
        np.float32)}, "bn": {"scale": rng.rand(8).astype(np.float32)}},
            "head": {"bias": np.zeros(5, np.float32)}}
    if wrapped:
        tree = {"params": tree}
    got, want = tparams.flatten_params(tree), jparams.flatten_params(tree)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    back = tparams.unflatten_params(got)
    assert tparams.flatten_params(back).keys() == got.keys()
    jback = jparams.unflatten_params(want)
    for k, v in tparams.flatten_params(back).items():
        np.testing.assert_array_equal(v, np.asarray(
            jparams.flatten_params(jback)[k]))
    npz = str(tmp_path / "p.npz")
    jparams.save_params_npz(npz, tree)
    loaded = tparams.flatten_params(tparams.load_params_npz(npz))
    jloaded = jparams.flatten_params(jparams.load_params_npz(npz))
    assert sorted(loaded) == sorted(jloaded)
    for k in jloaded:
        np.testing.assert_array_equal(loaded[k], np.asarray(jloaded[k]))


def test_native_available_is_a_query(monkeypatch):
    assert tnative.available() is True                 # g++ builds it here

    def fail():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "build_library", fail)
    assert tnative.available() is False
    with pytest.raises(RuntimeError, match="no compiler"):
        tnative.library()
