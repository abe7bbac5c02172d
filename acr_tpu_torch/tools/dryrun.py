"""Entry points on the port: the forward step, over replicas and processes.

Counterpart of ``__graft_entry__.py``:

* ``entry()`` returns (fn, example_args) for the flagship end-to-end
  inference step at 512 px (``fn(image, offsets)`` is ``forward_fn``);
* ``dryrun_multichip(n)`` runs that step over an n-replica mesh
  (``parallel.mesh``) and holds it bit for bit against one replica
  running the same shards, then the sharded folder-mode chunk step
  (forward, a render per frame, the capacity probe);
* ``dryrun_multiprocess(n_processes, replicas_per_process)`` spawns fresh
  interpreters that join over gloo (``init_distributed``) and run the
  step over the global mesh in every rank.

They run on the card unless the caller passes ``device="cpu"``; without
a card they raise. The replicas are the local cards, ``cuda:0`` repeated
where there are fewer cards than replicas. JAX's ``dryrun_multichip``
falls back to a virtual CPU mesh when it has too few devices; the port
does not. The weights are ``checkpoints/wild.npz``, made by
``tools.make_synthetic_checkpoint`` where it is absent (``model_path``
names another file), and the MANO assets ``model_data/mano``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Dict, Optional

import numpy as np
import torch

from acr_tpu_torch.config import _REPO_ROOT

MANO_DIR = os.path.join(_REPO_ROOT, "model_data", "mano")
CKPT = os.path.join(_REPO_ROOT, "checkpoints", "wild.npz")


def _ensure_assets(model_path: str = CKPT) -> None:
    """Generate synthetic MANO assets / checkpoint if real ones absent."""
    if not os.path.exists(os.path.join(MANO_DIR, "mano_left.npz")):
        from acr_tpu_torch.tools.make_synthetic_mano import write_assets
        write_assets(MANO_DIR)
    if not os.path.exists(model_path):
        from acr_tpu_torch.tools.make_synthetic_checkpoint import main
        main(["--out", model_path])


def replica_devices(n: int, device="cuda"):
    """``n`` replica devices: the CPU ``n`` times for ``device="cpu"``,
    else the local cards in order, ``cuda:0`` onwards again where there
    are fewer cards than replicas. Raises without a card."""
    from acr_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        return ["cpu"] * n
    count = torch.cuda.device_count()
    return [f"cuda:{i % count}" for i in range(n)]


def _config(input_size: int, precision: str = "fp32", quantize: str = "none",
            model_path: str = CKPT, **over):
    from acr_tpu_torch.config import Config
    # ACR_USE_PALLAS=1 forces the fused MANO kernel, as in JAX; else the
    # auto dispatch (fused from PALLAS_MANO_MIN_BATCH hands per call)
    pallas = "on" if os.environ.get("ACR_USE_PALLAS", "") == "1" else "auto"
    return Config(input_size=input_size, mano_model_path=MANO_DIR,
                  model_path=model_path, model_precision=precision,
                  quantize=quantize, use_pallas_mano=pallas,
                  configs_yml="", **over)


def _build(input_size: int, precision: str = "fp32", quantize: str = "none",
           device="cuda", model_path: str = CKPT):
    """(fn, pipeline): ``fn(image, offsets)`` is ``forward_fn`` on the
    pipeline's network and MANO assets, without autograd."""
    from acr_tpu_torch.pipeline.infer import ACRPipeline, forward_fn
    cfg = _config(input_size, precision, quantize, model_path)
    pipe = ACRPipeline(cfg, device=device)

    @torch.no_grad()
    def fn(image, offsets):
        return forward_fn(pipe.net, pipe.mano_l, pipe.mano_r, image, offsets,
                          cfg, merge_params=pipe.merge_params)
    return fn, pipe


def example_inputs(batch: int, size: int, device="cpu", seed: int = 0):
    """A seeded uint8 frame batch (batch, size, size, 3) and its offsets
    (an unpadded square frame)."""
    image = np.random.RandomState(seed).randint(
        0, 255, (batch, size, size, 3)).astype(np.uint8)
    offsets = np.tile(np.array([[size, size, 0, 0, 0, 0, 0, 0, 0, 0]],
                               np.float32), (batch, 1))
    return (torch.from_numpy(image).to(device),
            torch.from_numpy(offsets).to(device))


def entry(device="cuda", model_path: str = CKPT):
    """(fn, example_args) — full 512 px two-hand inference step on
    ``device``."""
    from acr_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    _ensure_assets(model_path)
    fn, pipe = _build(512, device=dev, model_path=model_path)
    image = torch.zeros((1, 512, 512, 3), dtype=torch.uint8, device=pipe.device)
    offsets = torch.tensor([[512, 512, 0, 0, 0, 0, 0, 0, 0, 0]],
                           dtype=torch.float32, device=pipe.device)
    return fn, (image, offsets)


def _check_shape(arr: np.ndarray, want) -> None:
    if arr.shape != tuple(want):
        raise AssertionError(f"shape {arr.shape}, want {tuple(want)}")


def _host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    from acr_tpu_torch.pipeline.app import readback
    return readback(out)


def dryrun_multichip(n_devices: int, input_size: int = 512, device="cuda",
                     model_path: str = CKPT,
                     render_size: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The FULL inference step over an ``n_devices``-replica mesh, once.

    Weights are replicated and the frame batch (one seeded frame per
    replica) sharded; the gathered outputs must equal, bit for bit, one
    replica running each shard in turn. Then the folder-mode chunk step
    (forward, a render per frame at ``render_size``, the capacity probe)
    runs sharded on the same mesh. ``ACR_DRYRUN_SIZE`` and
    ``ACR_DRYRUN_RENDER`` (128 by default) override the sizes, as in
    JAX. Returns the gathered forward outputs on the host."""
    from acr_tpu_torch.pipeline.app import ACRApp
    from acr_tpu_torch.pipeline.infer import ACRPipeline
    input_size = int(os.environ.get("ACR_DRYRUN_SIZE", input_size))
    render_size = render_size or int(os.environ.get("ACR_DRYRUN_RENDER",
                                                    "128"))
    devices = replica_devices(n_devices, device)
    _ensure_assets(model_path)
    cfg = _config(input_size, model_path=model_path,
                  data_parallel=n_devices)
    pipe = ACRPipeline(cfg, devices=devices)
    image, offsets = example_inputs(n_devices, input_size)
    out = _host(pipe(image, offsets))
    _check_shape(out["verts"], (n_devices, 2, 778, 3))
    one = ACRPipeline(_config(input_size, model_path=model_path),
                      device=devices[0])
    shards = [_host(one(image[k:k + 1], offsets[k:k + 1]))
              for k in range(n_devices)]
    for key, val in out.items():
        want = np.concatenate([s[key] for s in shards])
        if not np.array_equal(val, want):
            raise AssertionError(
                f"dryrun_multichip({n_devices}): {key} differs from one "
                f"replica (max abs {np.abs(val - want).max()})")
    print(f"dryrun_multichip({n_devices}): OK — verts {out['verts'].shape} "
          f"on {devices}, equal to one replica bit for bit", flush=True)

    ccfg = _config(input_size, model_path=model_path, demo_mode="folder",
                   data_parallel=n_devices, val_batch_size=n_devices,
                   temporal_optimization=False, renderer="tpu",
                   render_size=render_size)
    app = ACRApp(ccfg, params=None, devices=devices)
    if not app._sharded_chunk:
        raise AssertionError(f"the chunk step is not sharded: "
                             f"{app._fused_bypass_reason}")
    chunk = _host(app.chunk_step(image, offsets))
    _check_shape(chunk["verts"], (n_devices, 2, 778, 3))
    _check_shape(chunk["_rgba"], (n_devices, 4, render_size, render_size))
    print(f"dryrun_multichip({n_devices}) sharded chunk: OK — verts "
          f"{chunk['verts'].shape}, rgba {chunk['_rgba'].shape}", flush=True)
    return out


def _multiprocess_worker(coordinator: str, num_processes: int,
                         process_id: int, local_replicas: int,
                         device: str = "cuda", model_path: str = CKPT,
                         input_size: int = 64) -> None:
    """One rank of the multi-process dry run (a fresh interpreter)."""
    from acr_tpu_torch.parallel.mesh import init_distributed
    from acr_tpu_torch.pipeline.infer import ACRPipeline
    init_distributed(coordinator, num_processes, process_id)
    n = num_processes * local_replicas
    cfg = _config(input_size, model_path=model_path, data_parallel=n)
    pipe = ACRPipeline(cfg, devices=replica_devices(local_replicas, device))
    if (pipe.mesh.rank, pipe.mesh.size) != (process_id, n):
        raise AssertionError(f"rank {process_id}: mesh {pipe.mesh}")
    image, offsets = example_inputs(n, input_size)
    out = _host(pipe(image, offsets))
    _check_shape(out["verts"], (n, 2, 778, 3))
    torch.distributed.destroy_process_group()
    print(f"multiprocess rank {process_id}/{num_processes}: OK — "
          f"verts {out['verts'].shape}", flush=True)


def dryrun_multiprocess(n_processes: int = 2, replicas_per_process: int = 1,
                        port: int = 0, timeout: float = 600.0,
                        device="cuda", model_path: str = CKPT,
                        input_size: int = 64) -> None:
    """Multi-HOST data-parallel smoke: spawn ``n_processes`` fresh
    interpreters, join them over gloo at ``localhost:port`` (the wiring a
    multi-host deployment uses with real addresses), and run the FULL
    step over the global mesh in every rank, at ``input_size`` (64 px, as
    in JAX). ``port=0`` binds an ephemeral port. Every process is killed
    if any outlives ``timeout`` seconds; a failed rank raises."""
    replica_devices(replicas_per_process, device)    # no card: raise here
    _ensure_assets(model_path)
    if port == 0:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
    coordinator = f"localhost:{port}"
    code = ("import sys; from acr_tpu_torch.tools.dryrun import "
            "_multiprocess_worker as w; "
            f"w({coordinator!r}, {n_processes}, int(sys.argv[1]), "
            f"{replicas_per_process}, {str(device)!r}, {model_path!r}, "
            f"{input_size})")
    env = dict(os.environ, ACR_INIT_TIMEOUT=str(int(timeout)))
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    env.pop("ACR_COORDINATOR", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(rank)], cwd=_REPO_ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(n_processes)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(
                f"rank {rank} failed (exit {p.returncode}):\n{out[-3000:]}")
        if f"multiprocess rank {rank}/{n_processes}: OK" not in out:
            raise RuntimeError(f"rank {rank} did not finish:\n{out[-500:]}")
    print(f"dryrun_multiprocess({n_processes}x{replicas_per_process}): OK",
          flush=True)
