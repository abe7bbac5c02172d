"""acr_tpu_torch.tools: the asset converters and the run tools.

Each module but ``dryrun`` and ``stream_setup`` runs as ``python -m
acr_tpu_torch.tools.<name>`` with the flags of its counterpart in the
repository's ``tools/`` (the JAX side); ``dryrun`` holds the functions of
``__graft_entry__.py``, ``stream_setup`` those of ``bench.py`` that the
stream tools and the port's bench (``acr_tpu_torch.bench``) drive:

  convert_checkpoint        — the reference's wild.pkl -> npz of flax paths
  convert_mano              — MANO_{LEFT,RIGHT}.pkl -> mano_{side}.npz
  make_synthetic_mano       — seeded MANO-shaped assets
  make_synthetic_checkpoint — seeded random-weight npz (checkpoints/wild.npz)
  make_calib_frames         — the int8 calibration set from a photo
  ingest_real_assets        — both conversions, the report and a smoke run
  quant_accuracy            — the W8A8 modes' error in output space
  profile_step              — a torch.profiler table of the forward step
  dryrun                    — the forward step, over replicas and processes
  stream_setup              — the webcam stream step on the realistic scene
  stream_bench              — StreamingLoop latency, p50/p90
  profile_stream            — a torch.profiler table of the stream step
  precision_ladder          — the b1 stream step at fp32/bf16/int8/2048 px

They import torch, numpy, scipy and cv2, and nothing of the JAX package.
The tools that run the network take ``--device`` (``cuda`` by default;
they raise without a card unless ``--device cpu`` is given). They read
no file outside the repository unless a flag names it: a photo is
``--image`` / ``--smoke_image``, the reference implementation's checkout
is ``--reference_init``.
"""
