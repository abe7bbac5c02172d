"""Data parallelism: replicas of the pipeline, one shard of the batch each.

Counterpart of ``acr_tpu/parallel/mesh.py``. JAX builds a 1-D 'data'
mesh over every process's devices, replicates the weights and lets XLA
shard the frame batch. Here a ``Mesh`` is this process's replica devices
and its rank among the processes; ``data_parallel`` is the global
replica count, as in JAX, and each process owns ``data_parallel /
num_processes`` replicas. A batch is padded to a multiple of the global
count (``pad_batch``), split into equal shards in rank order
(``split_batch``), each local replica runs its own shards, and
``gather_outputs`` puts the outputs back together on the lead replica.

Across processes the gather is an ``all_gather`` over ``gloo`` on host
copies, so every rank ends up holding the whole batch, as JAX's
replicated ``out_shardings`` give. gloo and not NCCL: NCCL refuses two
ranks on one device, and a machine with one card runs its ranks there.

A replica device may be named twice (``make_mesh(2, devices=["cuda:0",
"cuda:0"])``): that runs the sharded path on one card.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from acr_tpu_torch.utils.device import resolve_device


class Mesh(NamedTuple):
    """This process's replica devices and its place among the processes."""
    devices: Tuple[torch.device, ...]   # local replicas; devices[0] leads
    rank: int = 0
    num_processes: int = 1

    @property
    def size(self) -> int:
        """The global replica count (JAX's ``mesh.size``)."""
        return len(self.devices) * self.num_processes

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def local_shards(self) -> range:
        """Indices, among ``size`` equal shards, of this process's ones."""
        n = len(self.devices)
        return range(self.rank * n, (self.rank + 1) * n)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     initialization_timeout: Optional[float] = None) -> bool:
    """Join a multi-process run at ``tcp://<coordinator>``, if configured.

    The arguments fall back to the environment (``ACR_COORDINATOR``,
    ``ACR_NUM_PROCESSES``, ``ACR_PROCESS_ID``; ``ACR_INIT_TIMEOUT``
    seconds for the rendezvous and every collective, 300 by default).
    Returns True when a process group is up, False when no coordinator
    is set (one process). Idempotent."""
    coordinator = coordinator or os.environ.get("ACR_COORDINATOR")
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("ACR_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("ACR_PROCESS_ID", "0"))
    if dist.is_initialized():
        return True
    if initialization_timeout is None:
        initialization_timeout = float(
            os.environ.get("ACR_INIT_TIMEOUT", "300"))
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=initialization_timeout))
    return True


def make_mesh(n_data: int, devices: Optional[Sequence] = None,
              device="cuda") -> Mesh:
    """A mesh of ``n_data`` replicas in all, ``n_data / processes`` here.

    The local replicas are ``devices`` when given (a device may repeat),
    else the first local cards, else, for ``device="cpu"``, the CPU as
    often as needed. Raises ValueError when there are fewer devices than
    replicas, or when the processes do not divide ``n_data``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data < 1 or n_data % world:
        raise ValueError(f"data_parallel={n_data} does not divide over "
                         f"{world} processes")
    n_local = n_data // world
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
    else:
        dev = resolve_device(device)
        if dev.type == "cpu":
            devs = [dev] * n_local
        else:
            devs = [torch.device(dev.type, i)
                    for i in range(torch.cuda.device_count())]
    if n_local > len(devs):
        raise ValueError(f"requested {n_data} devices, have "
                         f"{len(devs) * world}")
    return Mesh(tuple(devs[:n_local]), rank, world)


def pad_batch(x: torch.Tensor, n: int) -> Tuple[torch.Tensor, int]:
    """Pad the batch axis to a multiple of ``n`` by repeating the last
    frame; returns (padded, number of frames added)."""
    pad = (-x.shape[0]) % n
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    return x, pad


def split_batch(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    """``n`` equal shards of the batch axis, in order."""
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split into "
                         f"{n} equal shards")
    return list(torch.chunk(x, n))


def gather_outputs(mesh: Mesh, outs: List[Dict[str, torch.Tensor]]
                   ) -> Dict[str, torch.Tensor]:
    """The local replicas' outputs (batch-leading tensors, in shard
    order) concatenated on the lead replica; across processes, every
    rank's, in rank order, on every rank."""
    local = {k: torch.cat([o[k].to(mesh.lead) for o in outs])
             for k in outs[0]}
    if mesh.num_processes == 1:
        return local
    full = {}
    for k in sorted(local):
        host = local[k].cpu().contiguous()
        is_bool = host.dtype == torch.bool
        if is_bool:
            host = host.to(torch.uint8)
        parts = [torch.empty_like(host) for _ in range(mesh.num_processes)]
        dist.all_gather(parts, host)
        v = torch.cat(parts)
        full[k] = (v.bool() if is_bool else v).to(mesh.lead)
    return {k: full[k] for k in local}
