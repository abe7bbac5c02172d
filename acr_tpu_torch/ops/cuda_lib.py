"""Build and load the port's CUDA kernels: one shared library from every
source in ``csrc/``.

At first use each source (``csrc/raster.cu``, ``csrc/mano.cu``,
``csrc/detect.cu``) is
compiled by its own ``nvcc`` process for ``sm_90a``, all started
together, and the objects are linked into one shared library with a plain
C interface under ``build/torch_ext/<hash of the sources and flags>/`` in
the checkout. It is loaded with ctypes; a launcher returns the CUDA error
of its launch (0 when the launch was accepted).

``--fmad=false`` keeps every multiply and add of the rasterizer's edge
math separately rounded, which its bit exactness against the plain
versions needs. The flag does not touch explicit fused multiply-adds
(``__fmaf_rn``), which the MANO kernel writes for its dot products.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
SOURCES = tuple(os.path.join(_PKG, "csrc", name)
                for name in ("raster.cu", "mano.cu", "detect.cu"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIB_NAME = "libacr_kernels.so"
# argument kinds of each C launcher: p a pointer (or the stream), i an int,
# f a float
_SIGNATURES = {
    "acr_raster_flat": "pppiiippppp",
    "acr_raster_binned": "ppppipiiiippppp",
    "acr_raster_banded": "pppiiiiiippppp",
    "acr_mano_fused": "ppppipp",
    "acr_nms": "ppfiipp",
    "acr_roi_align": "ppppiiifppiipp",
}
_lib = None
_lib_lock = threading.Lock()


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc): cannot build the "
                           "port's CUDA kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_extension() -> Tuple[str, str]:
    """Compile the sources if these exact sources and flags have no build
    yet: one ``nvcc -c`` per source in parallel, then one link.

    Returns (path of the shared library, the compilers' log, which holds
    ptxas' register and spill report; empty when the build existed)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(_REPO, "build", "torch_ext", h.hexdigest()[:16])
    so = os.path.join(out_dir, _LIB_NAME)
    if os.path.exists(so):
        return so, ""
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(out_dir, f"{os.path.basename(s)}.{tag}.o")
            for s in SOURCES]
    procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = f"{so}.{tag}"
    proc = subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                           "-shared", "-o", tmp, *objs],
                          capture_output=True, text=True)
    log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
    for obj in objs:
        os.remove(obj)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(log)
    os.replace(tmp, so)
    return so, log


def library():
    """The loaded library, built at first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            so, _ = build_extension()
            lib = ctypes.CDLL(so)
            kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                     "f": ctypes.c_float}
            for name, sig in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [kinds[k] for k in sig]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device):
    """Raise unless ``t`` has this dtype, shape and device and is contiguous."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# The current stream as a raw handle, as PyTorch's own generated kernels
# read it, without building a Stream object: about 7 us less host time per
# launch on the H100 host (torch 2.11). It is a private function, so the
# public API stands in where a torch release lacks it.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _current_stream(index: int) -> int:
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(fn, device, *args) -> None:
    """Call launcher ``fn`` on the device's current stream; raise on a
    launch error. The device guard is entered only when ``device`` is not
    the current device."""
    current = torch.cuda.current_device()
    if device.index in (None, current):
        err = fn(*args, _current_stream(current))
    else:
        with torch.cuda.device(device):
            err = fn(*args, _current_stream(device.index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
