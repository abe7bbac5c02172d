"""The port's stream tools against the JAX package's, and its atomic asset writes.

``acr_tpu_torch.tools.stream_setup`` against ``bench.py``'s stream-step
scaffolding, and ``stream_bench``, ``profile_stream`` and
``precision_ladder`` against ``tools/``, all on the CPU:

* the realistic scene: the port's served weights after the scene equal
  JAX's ``_build_stream_app`` leaves at fp32 and bf16, each JAX leaf
  taken in the network's compute dtype (flax casts the float32 scene
  bias of a bf16 tree when it applies it); the leaves compared are every
  leaf of the canonical tree that JAX's 512 px layout rewrites leave
  alone, the fuse convs among them;
* one stream step on the scene at 128 px input and render against JAX's
  ``_jit_stream_step`` on the same npz, to
  ``tests/test_torch_port_stream.py``'s tolerances (rtol 2e-3, atol
  1e-3; the OneEuro state 1e-5; the RGBA 1e-3 plus half of the 8-bit
  step of JAX's packed RGBA);
* ``measure_stream_b1``: JAX's keys, steps and readbacks for each of
  the ladder's variants (both sides' scaffolding replaced by counters),
  and one real run on the CPU;
* the three tools' ``main`` with ``--device cpu``: ``stream_bench`` and
  ``profile_stream`` run for real (``--reuse`` gives the capture's rows);
  ``precision_ladder`` makes JAX's calls, with the measurement replaced
  by a recorder (its real run is ``measure_stream_b1``'s; a real ladder
  of three precisions takes over a minute on the CPU); every entry point
  raises without a card;
* two processes that make the same missing assets at once
  (``dryrun._ensure_assets``) each load a whole checkpoint, equal array
  for array to a single write.
"""

import inspect
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as ge
import bench
from acr_tpu.config import Config as JaxConfig
from acr_tpu.io.params import flatten_params, unflatten_params
from acr_tpu.pipeline.app import ACRApp as JaxACRApp
from acr_tpu.pipeline.app import unpack_outputs
from acr_tpu_torch.config import Config
from acr_tpu_torch.io.params import load_params, save_params_npz, to_flax
from acr_tpu_torch.pipeline.app import ACRApp, readback
from acr_tpu_torch.tools import (
    precision_ladder,
    profile_stream,
    stream_bench,
    stream_setup,
)
from acr_tpu_torch.tools.make_synthetic_checkpoint import make_params
from tools import precision_ladder as jax_ladder

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED_MANO = os.path.join(REPO, "model_data", "mano")
SMALL = 128
RTOL, ATOL = 2e-3, 1e-3            # tests/test_torch_port_stream.py
FUSE = ["l_fuse_conv/bias", "l_fuse_conv/kernel", "r_fuse_conv/bias",
        "r_fuse_conv/kernel"]

_RACER = """
import os, sys, time
import numpy as np
from acr_tpu_torch.io.params import load_params
from acr_tpu_torch.tools import dryrun, make_synthetic_checkpoint as msc
root, rank = sys.argv[1], int(sys.argv[2])
dryrun.MANO_DIR = os.path.join(root, "mano")
mine, other = (os.path.join(root, f"done_{k}") for k in (rank, 1 - rank))
if rank == 1:
    # found the checkpoint absent, as rank 0 did; writes it while rank 0
    # reads its own
    make_params = msc.make_params
    def late_params(seed):
        while not os.path.exists(other):
            time.sleep(0.005)
        return make_params(seed)
    msc.make_params = late_params
open(os.path.join(root, f"ready_{rank}"), "w").close()
while not os.path.exists(os.path.join(root, "go")):
    time.sleep(0.005)
dryrun._ensure_assets(os.path.join(root, "wild.npz"))
open(mine, "w").close()
# read every array until the other process has written the file too,
# and once after; then load it as the pipeline does
while True:
    finished = os.path.exists(other)
    with np.load(os.path.join(root, "wild.npz")) as data:
        [data[k] for k in data.files]
    if finished:
        break
load_params(os.path.join(root, "wild.npz"))
print("loaded", flush=True)
"""


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """(checkpoint, MANO dir): made by two processes through
    ``dryrun._ensure_assets``, released by one file once both have
    imported, so both find them absent; the second writes the checkpoint
    after the first has, while the first reads it back. Each loads the
    checkpoint after its own write until the other has written too.
    Returns the paths, the processes' exit codes and outputs, and their
    directory."""
    root = tmp_path_factory.mktemp("assets")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", _RACER, str(root), str(k)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for k in range(2)]
    try:
        deadline = time.time() + 120
        while not all((root / f"ready_{k}").exists() for k in range(2)):
            assert time.time() < deadline, "the writers did not start"
            assert all(p.poll() is None for p in procs), \
                [p.communicate()[0] for p in procs]
            time.sleep(0.01)
        (root / "go").touch()
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return (str(root / "wild.npz"), str(root / "mano"),
            [(p.returncode, out) for p, out in zip(procs, outs)], root)


def test_concurrent_ensure_assets_leave_whole_files(assets, tmp_path):
    ckpt, mano, runs, root = assets
    for code, out in runs:
        assert code == 0 and "loaded" in out, out[-3000:]
    # one checkpoint, one MANO pair, no temporary file left behind
    assert sorted(os.listdir(root)) == ["done_0", "done_1", "go", "mano",
                                        "ready_0", "ready_1", "wild.npz"]
    assert sorted(os.listdir(mano)) == ["mano_left.npz", "mano_right.npz"]
    single = str(tmp_path / "single.npz")
    save_params_npz(single, make_params(0))
    for got_path, want_path in [(ckpt, single)] + [
            (os.path.join(mano, f), os.path.join(COMMITTED_MANO, f))
            for f in ("mano_left.npz", "mano_right.npz")]:
        with np.load(got_path) as got, np.load(want_path) as want:
            assert got.files == want.files
            for k in want.files:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    state_dict, fusion = load_params(ckpt)
    assert fusion is None and len(state_dict) == len(make_params(0))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_scene_matches_jax(assets, monkeypatch, precision):
    ckpt, mano, _, _ = assets
    monkeypatch.setattr(ge, "CKPT", ckpt)
    monkeypatch.setattr(ge, "MANO_DIR", mano)
    want = flatten_params(bench._build_stream_app(precision).pipeline.params)
    app = stream_setup.build_stream_app(precision, device="cpu",
                                        model_path=ckpt)
    got = to_flax({k: v.float() for k, v in
                   app.pipeline.net.state_dict().items()})
    assert [k for k in got if "fuse_conv" in k] == FUSE
    assert [k for k in want if "fuse_conv" in k] == FUSE
    dtype = jnp.bfloat16 if precision == "bf16" else jnp.float32
    same = [k for k in got if k in want and got[k].shape == want[k].shape]
    assert set(FUSE) <= set(same) and len(same) > 700
    for k in same:
        w = np.asarray(jnp.asarray(want[k]).astype(dtype).astype(jnp.float32))
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    ty = float(jnp.asarray(0.45, dtype))          # 0.44921875 in bf16
    for side, sign in (("l", -1.0), ("r", 1.0)):
        assert not got[f"{side}_fuse_conv/kernel"].any()
        np.testing.assert_array_equal(
            got[f"{side}_fuse_conv/bias"],
            np.float32([5.0, 0.0, sign * ty] + [1, 0, 0, 0, 1, 0] * 16
                       + [0.0] * 10))


def test_realistic_scene_takes_any_state_dict():
    sd = {"net.l_fuse_conv.weight": torch.ones(3, 2, 1, 1),
          "net.l_fuse_conv.bias": torch.ones(109, dtype=torch.bfloat16),
          "r_fuse_conv.bias": torch.ones(109),
          "r_fuse_conv.kernel_q": torch.ones(3, 2, 1, 1, dtype=torch.int8),
          "fuse.weight": torch.ones(2)}
    out = stream_setup.realistic_scene(sd)
    assert out.keys() == sd.keys() and out is not sd
    assert not out["net.l_fuse_conv.weight"].any()
    assert out["net.l_fuse_conv.bias"][2] == -0.45
    assert out["r_fuse_conv.bias"][:3].tolist() == \
        np.float32([5.0, 0.0, 0.45]).tolist()
    assert out["r_fuse_conv.kernel_q"] is sd["r_fuse_conv.kernel_q"]
    assert out["fuse.weight"] is sd["fuse.weight"]
    assert sd["r_fuse_conv.bias"].eq(1).all()          # the input is kept


def state_leaves(state):
    """The leaves of a OneEuro state (NamedTuples of tensors), in order."""
    if isinstance(state, tuple):
        return [x for s in state for x in state_leaves(s)]
    return [state]


def _small_cfg(cfg_cls, ckpt, mano, tmp_path, name):
    return cfg_cls(input_size=SMALL, render_size=SMALL, model_path=ckpt,
                   mano_model_path=mano, configs_yml="", renderer="tpu",
                   centermap_conf_thresh=-1e9, temporal_optimization=True,
                   demo_mode="webcam", output_dir=str(tmp_path / name) + "/")


def test_scene_stream_step_matches_jax(assets, tmp_path):
    ckpt, mano, _, _ = assets
    app = ACRApp(_small_cfg(Config, ckpt, mano, tmp_path, "port"),
                 device="cpu")
    net = app.pipeline.net
    net.load_state_dict(stream_setup.realistic_scene(net.state_dict()))
    scene = to_flax({k: v for k, v in net.state_dict().items()
                     if "fuse_conv" in k})
    japp = JaxACRApp(_small_cfg(JaxConfig, ckpt, mano, tmp_path, "jax"))
    pl = japp.pipeline
    flat = flatten_params(pl.params)
    flat.update({k: scene[k] for k in FUSE})
    pl.params = unflatten_params(flat)

    image = np.random.RandomState(3).randint(
        0, 255, (1, SMALL, SMALL, 3)).astype(np.uint8)
    offsets = np.float32([[SMALL, SMALL, 0, 0, 0, 0, 0, 0, 0, 0]])
    state, packed = japp._jit_stream_step(
        pl.params, pl.mano_l, pl.mano_r, japp.filter_state,
        image.reshape(1, SMALL, SMALL * 3), offsets)
    want = unpack_outputs(packed, japp._stream_spec)
    got = readback(app.stream_step({"image": torch.from_numpy(image),
                                    "offsets": torch.from_numpy(offsets)}))
    assert got.keys() == want.keys()
    assert got["detection_flag"].all()
    for k in sorted(set(want) - {"_rgba"}):
        if want[k].dtype == bool or np.issubdtype(want[k].dtype, np.integer):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    # JAX packs its RGBA to 8 bits (round(v * 255) / 255), channel-minor
    w_rgba = np.moveaxis(want["_rgba"], -1, 0)
    assert got["_rgba"].shape == w_rgba.shape == (4, SMALL, SMALL)
    assert got["_rgba"][3].sum() > 500
    np.testing.assert_array_equal(got["_rgba"][3], w_rgba[3])
    np.testing.assert_allclose(got["_rgba"], w_rgba, atol=1e-3 + 0.5 / 255)
    g_state = state_leaves(app.filter_state)
    w_state = jax.tree.leaves(state)
    assert len(g_state) == len(w_state) == 24
    for g, w in zip(g_state, w_state):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_stream_step_setup_contract(assets):
    ckpt, _, _, _ = assets
    sig = inspect.signature(stream_setup.stream_step_setup)
    assert list(sig.parameters)[:3] == ["precision", "quantize", "render_size"]
    assert [sig.parameters[k].kind for k in ("device", "model_path")] == \
        [inspect.Parameter.KEYWORD_ONLY] * 2
    assert "stream_step_setup" in inspect.getsource(profile_stream.capture)
    app, step, state, uploads, force = stream_setup.stream_step_setup(
        device="cpu", model_path=ckpt)
    assert step == app.stream_step and state is app.filter_state
    assert force is stream_setup.force_readback
    cfg = app.cfg
    assert (cfg.input_size, cfg.render_size, cfg.demo_mode, cfg.renderer,
            cfg.temporal_optimization) == (512, 512, "webcam", "tpu", True)
    bufs = uploads(2)
    assert len(bufs) == 2 and bufs[0][0] is not bufs[1][0]
    image, offsets = bufs[0]
    assert image.shape == (1, 512, 512, 3) and image.dtype == torch.uint8
    assert offsets.tolist() == [[512, 512, 0, 0, 0, 0, 0, 0, 0, 0]]


class _Counts:
    def __init__(self):
        self.setup, self.steps, self.reads = [], 0, 0


def _jax_fake_setup(counts):
    class Pipeline:
        params = mano_l = mano_r = None

    class App:
        pipeline = Pipeline()

    def setup(precision="fp32", quantize="none", render_size=512):
        counts.setup.append((precision, quantize, render_size))

        def step(params, ml, mr, state, image, offsets):
            counts.steps += 1
            return state, jnp.zeros(4)

        def force(packed):
            counts.reads += 1
            return 0.0
        return App(), step, None, lambda n: [(None, None)] * n, force
    return setup


def _port_fake_setup(counts):
    class Pipeline:
        device = torch.device("cpu")

    class App:
        pipeline = Pipeline()

    def setup(precision="fp32", quantize="none", render_size=512, *,
              device="cuda", model_path=None):
        counts.setup.append((precision, quantize, render_size))

        def step(meta):
            counts.steps += 1
            return {}

        def force(out):
            counts.reads += 1
            return 0.0
        return App(), step, None, lambda n: [(None, None)] * n, force
    return setup


@pytest.mark.parametrize("name,kwargs", precision_ladder.variants(True),
                         ids=[n for n, _ in precision_ladder.variants(True)])
def test_measure_follows_jax(monkeypatch, name, kwargs):
    want_n, got_n = _Counts(), _Counts()
    monkeypatch.setattr(bench, "stream_step_setup", _jax_fake_setup(want_n))
    monkeypatch.setattr(stream_setup, "stream_step_setup",
                        _port_fake_setup(got_n))
    want = bench._measure_stream_b1(2, 3, **kwargs)
    got = stream_setup.measure_stream_b1(2, 3, device="cpu", **kwargs)
    assert got.pop("card") == "cpu"
    assert list(got) == list(want)
    assert vars(got_n) == vars(want_n)
    iters = max(2, kwargs.get("min_iters", 0))
    assert want_n.steps == 4 + 3 * iters and want_n.reads == 2 + 3


def test_measure_stream_b1_on_the_cpu(assets):
    ckpt, _, _, _ = assets
    r = stream_setup.measure_stream_b1(1, 1, render_size=SMALL, tag="_x",
                                       device="cpu", model_path=ckpt)
    assert list(r) == ["stream_step_ms_b1_x", "stream_step_ms_b1_x_p50",
                       "stream_step_ms_b1_x_p90", "stream_readback_ms_x",
                       "card"]
    assert r["card"] == "cpu"
    assert all(np.isfinite(v) and v > 0 for k, v in r.items() if k != "card")


def test_precision_ladder_makes_jax_calls(assets, monkeypatch, capsys):
    ckpt, _, _, _ = assets
    calls = {"jax": [], "port": []}

    def recorder(side):
        def measure(iters, reps, **kw):
            kw.pop("device", None), kw.pop("model_path", None)
            calls[side].append((iters, reps, kw))
            tag = kw.get("tag", "")
            return {f"stream_step_ms_b1{tag}": 1.0}
        return measure
    monkeypatch.setattr(ge, "_ensure_assets", lambda: None)
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    monkeypatch.setattr(bench, "_measure_stream_b1", recorder("jax"))
    monkeypatch.setattr(stream_setup, "measure_stream_b1", recorder("port"))
    argv = ["--iters", "2", "--reps", "3", "--with_2048"]
    jax_ladder.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = precision_ladder.main(argv + ["--device", "cpu",
                                        "--model_path", ckpt])
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == got
    assert calls["port"] == calls["jax"] and len(calls["jax"]) == 4
    assert want.pop("backend") == "cpu"
    assert (got.pop("device"), got.pop("card")) == ("cpu", "cpu")
    assert got == want
    assert [line.split(":")[0] for line in err.strip().splitlines()] == \
        ["# fp32", "# bf16", "# int8", "# 2048px"]


def test_stream_bench_on_the_cpu(assets, capsys):
    ckpt, _, _, _ = assets
    lat = stream_bench.main(["--frames", "1", "--device", "cpu",
                             "--model_path", ckpt])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"1 frames  p50=[0-9.]+ ms  p90=[0-9.]+ ms  "
                        r"mean=[0-9.]+ ms  \[cpu\]", line), line
    assert len(lat) == 1 and lat[0] > 0


def test_profile_stream_reuse_gives_the_capture_rows(assets, tmp_path,
                                                     capsys):
    ckpt, _, _, _ = assets
    argv = ["--device", "cpu", "--render_size", str(SMALL), "--iters", "1",
            "--top", "8", "--model_path", ckpt,
            "--trace_dir", str(tmp_path / "trace")]
    rows = profile_stream.main(argv)
    text = capsys.readouterr().out
    assert len(os.listdir(tmp_path / "trace")) == 1
    assert "# total self CPU time" in text and "conv/GEMM" in text
    assert f"render {SMALL} px, fp32/none [cpu]" in text
    again = profile_stream.main(argv + ["--reuse"])
    assert capsys.readouterr().out == text
    # the same rows; rows of equal time may come in either order
    got = {r["op"]: r for r in again}
    assert len(got) == len(again) == len(rows)
    for r in rows:
        a = got[r["op"]]
        assert (a["category"], a["occurrences"]) == \
            (r["category"], r["occurrences"]), r["op"]
        assert a["self_us"] == pytest.approx(r["self_us"], abs=1e-3), r["op"]


@pytest.mark.parametrize("entry", [
    lambda p: stream_bench.main(["--frames", "1", "--model_path", p]),
    lambda p: profile_stream.main(["--model_path", p]),
    lambda p: precision_ladder.main(["--model_path", p]),
    lambda p: stream_setup.build_stream_app(model_path=p),
    lambda p: stream_setup.stream_step_setup(model_path=p),
    lambda p: stream_setup.measure_stream_b1(1, 1, model_path=p),
], ids=["stream_bench", "profile_stream", "precision_ladder",
        "build_stream_app", "stream_step_setup", "measure_stream_b1"])
def test_entry_points_raise_without_a_card(assets, entry):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry(assets[0])
