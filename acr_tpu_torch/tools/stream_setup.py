"""The webcam stream step's scaffolding, shared by the stream tools.

Counterpart of ``bench.py:127-279`` (``_build_stream_app``,
``_force_packed``, ``stream_step_setup``, ``_measure_stream_b1``), the
part of the bench that ``tools/profile_stream.py`` and
``tools/precision_ladder.py`` drive; the bench itself is
``acr_tpu_torch.bench``, which drives them too.

* ``realistic_scene`` overwrites the part module's fuse convs, which emit
  each hand's parameters in ``offset_mode='concat'``, to a constant
  two-hand scene: zero kernels, and biases [scale 5, tx 0, ty -/+0.45,
  identity 6D poses, zero betas]. Two canonical hands side by side, each
  about 260 x 130 px at 512: the scene the JAX tools measured. The convs
  still run; only the regressed values change, so every stage before the
  render does the same work as on any other weights.
* ``build_stream_app`` is the webcam app (512 px input, ``-t``, the
  device render at ``render_size``) on that scene;
* ``stream_step_setup`` returns ``(app, step, state, uploads, force)``:
  ``step(meta)`` is ``app.stream_step``, ``uploads(n)`` makes ``n``
  fresh device pairs of the seeded frame, and ``force(out)`` reads a
  step's outputs back;
* ``measure_stream_b1`` times chained steps ended by one readback.

JAX packs the step's outputs into one buffer and feeds the frame as a
lane-flattened ``(1, 512, 1536)`` array, workarounds for the TPU and its
relayed transport; the port reads back its output dict and takes the
frame as ``(1, 512, 512, 3)``. Everything here runs on the card unless
the caller passes ``device="cpu"``, and raises without a card.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from acr_tpu_torch.tools.dryrun import CKPT, MANO_DIR, _ensure_assets
from acr_tpu_torch.utils.device import card_line, resolve_device

SIZE = 512                      # the webcam path's input size
IDENTITY_6D = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0] * 16


def realistic_scene(state_dict: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """A copy of ``state_dict`` whose ``*fuse_conv`` weights are zero and
    whose biases are [5, 0, side * 0.45] + identity 6D x 16 + zeros(10),
    side +1 for a module named ``r...`` and -1 otherwise (JAX's
    ``_realistic_scene``, ``bench.py:159-173``). The biases are float32;
    loading them into a bf16 network rounds them as flax's apply does."""
    out = dict(state_dict)
    for key, value in state_dict.items():
        module, _, leaf = key.rpartition(".")
        name = module.rpartition(".")[2]
        if not name.endswith("fuse_conv"):
            continue
        if leaf == "weight":
            out[key] = torch.zeros_like(value)
        elif leaf == "bias":
            side = 1.0 if name.startswith("r") else -1.0
            out[key] = torch.tensor([5.0, 0.0, side * 0.45] + IDENTITY_6D
                                    + [0.0] * 10, dtype=torch.float32,
                                    device=value.device)
    return out


def build_stream_app(precision: str = "fp32", quantize: str = "none",
                     render_size: int = 512, *, device="cuda",
                     model_path: str = CKPT):
    """The webcam latency path's ``ACRApp`` on the realistic scene: 512 px
    input, ``-t``, the device render at ``render_size``, the weights of
    ``model_path`` (made by ``make_synthetic_checkpoint`` where absent)
    served at ``precision`` / ``quantize``, then the scene applied to the
    served network."""
    from acr_tpu_torch.config import Config
    from acr_tpu_torch.pipeline.app import ACRApp
    dev = resolve_device(device)
    _ensure_assets(model_path)
    cfg = Config(input_size=SIZE, mano_model_path=MANO_DIR,
                 model_path=model_path, demo_mode="webcam",
                 temporal_optimization=True, renderer="tpu",
                 render_size=render_size, model_precision=precision,
                 quantize=quantize)
    app = ACRApp(cfg, device=dev)
    net = app.pipeline.net
    net.load_state_dict(realistic_scene(net.state_dict()))
    return app


def force_readback(out: Dict[str, torch.Tensor]) -> float:
    """The app's whole readback of a step's outputs (one synchronisation,
    every output to the host); returns the sum of ``verts``, finite."""
    from acr_tpu_torch.pipeline.app import readback
    return float(readback(out)["verts"].sum())


def stream_step_setup(precision: str = "fp32", quantize: str = "none",
                      render_size: int = 512, *, device="cuda",
                      model_path: str = CKPT):
    """``(app, step, state, uploads, force)`` on the realistic scene.

    ``step({"image": image, "offsets": offsets})`` issues one frame's
    device work (forward, OneEuro, refine, render) and returns its device
    outputs; it carries ``app.filter_state`` (``state``) itself.
    ``uploads(n)`` returns ``n`` fresh (image uint8 (1, 512, 512, 3),
    offsets float32 (1, 10)) pairs on the device, synchronised once, so a
    timed loop measures the steps and not the uploads. ``force`` is
    ``force_readback``."""
    app = build_stream_app(precision, quantize, render_size, device=device,
                           model_path=model_path)
    dev = app.pipeline.device
    image = torch.from_numpy(np.random.RandomState(0).randint(
        0, 255, (1, SIZE, SIZE, 3)).astype(np.uint8))
    offsets = torch.tensor([[SIZE, SIZE, 0, 0, 0, 0, 0, 0, 0, 0]],
                           dtype=torch.float32)

    def uploads(n):
        bufs = [(image.to(dev, copy=True), offsets.to(dev, copy=True))
                for _ in range(n)]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return bufs

    return app, app.stream_step, app.filter_state, uploads, force_readback


def measure_stream_b1(iters: int, reps: int, precision: str = "fp32",
                      quantize: str = "none", render_size: int = 512,
                      tag: str = "", min_iters: int = 0, *, device="cuda",
                      model_path: str = CKPT) -> Dict:
    """The b1 stream step, JAX's method (``bench.py:222-279``): 4 warm-up
    steps; one readback of a finished result timed; then ``reps`` times
    ``max(iters, min_iters)`` chained steps on fresh uploads, ended by one
    readback, less the readback's time, per step. Returns the median and
    the p50 / p90 across the repetitions (ms), the readback (ms), under
    JAX's keys with ``tag``, and ``card``: the card's name and power
    limit (``nvidia-smi``), or ``cpu``."""
    iters = max(iters, min_iters)
    app, step, _, uploads, force = stream_step_setup(
        precision, quantize, render_size, device=device,
        model_path=model_path)
    for image, offsets in uploads(4):              # set-up + warm-up
        out = step({"image": image, "offsets": offsets})
    force(out)
    time.sleep(0.05)
    t = time.perf_counter()
    force(out)                                     # a finished result
    readback_s = time.perf_counter() - t

    per_rep_ms = []
    for _ in range(reps):
        bufs = uploads(iters)
        t0 = time.perf_counter()
        for image, offsets in bufs:
            out = step({"image": image, "offsets": offsets})
        force(out)
        dt = max(time.perf_counter() - t0 - readback_s, 1e-9)
        per_rep_ms.append(dt * 1e3 / iters)
    per_rep_ms.sort()
    return {
        f"stream_step_ms_b1{tag}": round(float(np.median(per_rep_ms)), 3),
        f"stream_step_ms_b1{tag}_p50":
            round(float(np.percentile(per_rep_ms, 50)), 3),
        f"stream_step_ms_b1{tag}_p90":
            round(float(np.percentile(per_rep_ms, 90)), 3),
        f"stream_readback_ms{tag}": round(readback_s * 1e3, 1),
        "card": card_line(app.pipeline.device),
    }
