"""Two processes, one replica each, joined over gloo (the port's
``init_distributed``), against one process.

Two fresh interpreters (the way two hosts would run, with a localhost
address) join at an ephemeral port through the config's ``coordinator``,
``num_processes`` and ``process_id``, build a 2-replica mesh on the CPU
and run one chunk of 4 frames at 64 px (render 64) through
``ACRApp.chunk_step``: each computes its 2 frames, and the gather brings
the whole chunk to both. Every rank's chunk must equal the one-process
chunk at tests/test_parallel.py's tolerances (2e-4; ``cam_trans``
5e-3, ``pj2d_org`` 2e-3, ``_rgba`` 1.5/255). The ranks' weights are
``init_params`` with the fuse convs biased so both hands are plausible
(as chip_smoke.py's). Each subprocess has a time limit of its own, and
the rendezvous the same timeout (``ACR_INIT_TIMEOUT``), as
``__graft_entry__.dryrun_multiprocess`` gives JAX's ranks. The file
imports nothing of the JAX package.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from acr_tpu_torch.config import Config
from acr_tpu_torch.pipeline.app import ACRApp
from test_torch_port_dp_cuda import assert_same_chunk
from test_torch_port_precision_cuda import _weights

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANO_DIR = os.path.join(REPO, "model_data", "mano")
SIZE = 64
TIMEOUT = 300

WORKER = """
import json, sys, numpy as np, torch
torch.set_num_threads(2)
from acr_tpu_torch.config import Config
from acr_tpu_torch.pipeline.app import ACRApp
rank, coordinator, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
data = np.load(work + '/frames.npz')
cfg = Config(**json.load(open(work + '/cfg.json')), data_parallel=2,
             coordinator=coordinator, num_processes=2, process_id=rank)
app = ACRApp(cfg, params=torch.load(work + '/params.pt'), device='cpu')
assert app.pipeline.mesh.rank == rank and app.pipeline.mesh.size == 2
assert app._sharded_chunk, app._fused_bypass_reason
out = app.chunk_step(data['image'], data['offsets'])
np.savez(f'{work}/rank{rank}.npz', **{k: v.numpy() for k, v in out.items()})
torch.distributed.destroy_process_group()
print(f'rank {rank}: OK', flush=True)
"""


def test_two_processes_gather_the_chunk(tmp_path):
    rng = np.random.RandomState(7)
    image = (rng.rand(4, SIZE, SIZE, 3) * 255).astype(np.uint8)
    offsets = np.tile(np.array([[SIZE, SIZE, 0, 0, 0, 0, 0, 0, 0, 0]],
                               np.float32), (4, 1))
    kw = dict(input_size=SIZE, render_size=SIZE, mano_model_path=MANO_DIR,
              configs_yml="", renderer="tpu", centermap_conf_thresh=-1e9,
              demo_mode="folder", val_batch_size=4, raster_overflow_every=1,
              output_dir=str(tmp_path / "out") + "/")
    params = _weights()
    np.savez(tmp_path / "frames.npz", image=image, offsets=offsets)
    torch.save(params, tmp_path / "params.pt")
    (tmp_path / "cfg.json").write_text(json.dumps(kw))

    # reserve an ephemeral port; it is free again before rank 0 binds it
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, ACR_INIT_TIMEOUT=str(TIMEOUT))
    env.pop("ACR_COORDINATOR", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(rank), f"localhost:{port}",
         str(tmp_path)], cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log[-3000:]}"
        assert f"rank {rank}: OK" in log

    want = ACRApp(Config(**kw), params=params, device="cpu").chunk_step(
        image, offsets)
    want = {k: v.numpy() for k, v in want.items()}
    assert want["_rgba"][:, 3].any()
    for rank in range(2):
        with np.load(tmp_path / f"rank{rank}.npz") as got:
            got = {k: got[k] for k in got.files}
        assert got["verts"].shape == (4, 2, 778, 3)
        assert_same_chunk(got, want)
