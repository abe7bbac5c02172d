"""acr_tpu_torch — the PyTorch / CUDA port of acr_tpu for an NVIDIA H100.

Same module layout and public names as ``acr_tpu`` (the JAX reference,
which stays in the repository); imports ``torch`` and never ``jax``.

Layout:
  config    — typed dataclass config + YAML overlay + CLI (copy of acr_tpu.config)
  io        — flax-path checkpoints (npz, or orbax directories read and
              written without orbax) -> state dicts, seeded init, writers,
              the ctypes bridge to the host C++ library (native/)
  models    — HRNet backbone, ACR heads and part module, MANO
  ops       — rotation math, the fused MANO kernel's wrapper, the CUDA
              build, W8A8 int8 convolutions and their calibration
  parallel  — data parallelism: replicas, shards, gloo gathers
  parser    — center-map decoding, parameter sampling, cross-hand prior,
              ground-truth centre maps
  pipeline  — preprocessing, inference chain, projection, OneEuro filter,
              capture, streaming loop, the app's four demo modes
  utils     — meters and stage timers (copy of acr_tpu.utils.meters), the
              device rule, the profiler trace, the config session
  viz       — rasterizer (CUDA kernels in csrc/raster.cu), compositing and
              the auxiliary views
"""

__version__ = "0.1.0"
