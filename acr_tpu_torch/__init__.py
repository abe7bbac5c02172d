"""acr_tpu_torch — the PyTorch / CUDA port of acr_tpu for an NVIDIA H100.

Same module layout and public names as ``acr_tpu`` (the JAX reference,
which stays in the repository); imports ``torch`` and never ``jax``.

Layout:
  config    — typed dataclass config + YAML overlay + CLI (copy of acr_tpu.config)
  io        — flax-path checkpoints -> state dicts, seeded init, result writer
  models    — HRNet backbone, ACR heads and part module, MANO
  ops       — rotation math
  parser    — center-map decoding, parameter sampling, cross-hand prior
  pipeline  — preprocessing, inference chain, projection, image-mode app
  viz       — rasterizer (CUDA kernels in csrc/raster.cu) and compositing
"""

__version__ = "0.1.0"
