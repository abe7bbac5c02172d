"""ctypes bridge to the host C++ library ``native/acr_native.cpp``.

Counterpart of ``acr_tpu/io/native.py``: the host translation solve
(``jit_translation_solve=False``: least squares, or RANSAC over it with
the reference's solvePnPRansac contract) and the host z-buffer renderer
(``renderer='native'``), the stand-ins for the reference's OpenCV and
pyrender. The port builds the repository's source itself, with the host
C++ compiler and ``native/Makefile``'s flags, into
``build/native/<hash of the source and flags>/libacr_native.so`` in the
checkout; it never runs ``make`` and never loads ``native/build/``, the
JAX package's build.

Where JAX warns and keeps the device solve when the library is missing,
the port raises: ``library()`` raises RuntimeError when the library
cannot be built or loaded, and the app calls it at construction when
either host path was asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "acr_native.cpp")
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
_LIB_NAME = "libacr_native.so"

_lib = None
_lib_lock = threading.Lock()


def build_library() -> str:
    """Compile ``SOURCE`` unless this exact source and these flags have a
    build already; returns the shared library's path."""
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join((CXX,) + CXX_FLAGS).encode())
    out_dir = os.path.join(_REPO, "build", "native", h.hexdigest()[:16])
    so = os.path.join(out_dir, _LIB_NAME)
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def available() -> bool:
    """Whether the library builds and loads here: a query, which never
    raises (JAX's ``available``). The paths that need the library call
    ``library()``, which raises."""
    try:
        library()
    except RuntimeError:
        return False
    return True


def library() -> ctypes.CDLL:
    """The loaded library, built at first use. Raises RuntimeError when
    it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(build_library())
            except (OSError, subprocess.SubprocessError) as exc:
                raise RuntimeError(
                    f"native library unavailable: cannot build or load "
                    f"{SOURCE} with {CXX}: {exc}") from exc
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.acr_estimate_translation.restype = ctypes.c_int
            lib.acr_estimate_translation.argtypes = [
                f32p, f32p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, f32p]
            lib.acr_estimate_translation_ransac.restype = ctypes.c_int
            lib.acr_estimate_translation_ransac.argtypes = [
                f32p, f32p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_uint,
                f32p]
            lib.acr_rasterize.restype = None
            lib.acr_rasterize.argtypes = [
                f32p, ctypes.c_int, i32p, ctypes.c_int, f32p, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, f32p]
            _lib = lib
    return _lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _rows(name: str, a, dtype, width: int) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype)
    if a.ndim != 2 or a.shape[1] != width:
        raise ValueError(f"{name}: want shape (n, {width}), got {a.shape}")
    return a


def estimate_translation(j3d: np.ndarray, uv: np.ndarray,
                         focal: float = 1265.0, cx: float = 256.0,
                         cy: float = 256.0, ransac: bool = True,
                         iterations: int = 100, reproj_thresh: float = 20.0,
                         seed: int = 0) -> np.ndarray:
    """Host translation solve of one hand: j3d (n, 3), uv (n, 2) pixels
    -> (3,) float32. RANSAC keeps the reference's robustness contract
    (reprojectionError=20, iterationsCount=100; acr/utils.py:421-422).
    Raises ValueError on a singular system."""
    lib = library()
    j3d = _rows("j3d", j3d, np.float32, 3)
    uv = _rows("uv", uv, np.float32, 2)
    if len(uv) != len(j3d):
        raise ValueError(f"{len(j3d)} joints but {len(uv)} image points")
    out = np.zeros(3, np.float32)
    if ransac:
        rc = lib.acr_estimate_translation_ransac(
            _fp(j3d), _fp(uv), len(j3d), focal, cx, cy, iterations,
            reproj_thresh, seed, _fp(out))
    else:
        rc = lib.acr_estimate_translation(
            _fp(j3d), _fp(uv), len(j3d), focal, cx, cy, _fp(out))
    if rc != 0:
        raise ValueError("translation solve failed (singular system)")
    return out


def rasterize(verts: np.ndarray, faces: np.ndarray, face_colors: np.ndarray,
              size: int = 512, focal: float = 1265.0,
              ambient: float = 0.3, directional: float = 1.5) -> np.ndarray:
    """Host z-buffer render of camera-space ``verts`` (V, 3), ``faces``
    (F, 3) and ``face_colors`` (F, 3) -> (size, size, 4) float32 RGBA."""
    lib = library()
    verts = _rows("verts", verts, np.float32, 3)
    faces = _rows("faces", faces, np.int32, 3)
    face_colors = _rows("face_colors", face_colors, np.float32, 3)
    if len(face_colors) != len(faces):
        raise ValueError(f"{len(faces)} faces but {len(face_colors)} colours")
    if faces.size and (faces.min() < 0 or faces.max() >= len(verts)):
        raise ValueError(f"face indices outside [0, {len(verts)})")
    out = np.zeros((size, size, 4), np.float32)
    lib.acr_rasterize(
        _fp(verts), len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
        _fp(face_colors), size, size, focal, size / 2.0, size / 2.0,
        ambient, directional, _fp(out))
    return out
