"""The port's bench against ``bench.py``, on the CPU.

* ``main`` in every mode of the environment (the default run, one
  forward config by precision and batch, ``ACR_BENCH_QUANT=int8``,
  ``ACR_BENCH_DP=2``), with the measurements of both sides replaced by
  recorders: the port makes JAX's calls in JAX's order with JAX's
  arguments, and prints JAX's line without ``vs_baseline``, with
  ``card``, and with ``mfu_pct`` for the roofline's ``mxu_util_pct``; a
  variant that raises leaves JAX's skip marker and its message on stderr;
* ``_measure`` at 128 px on the CPU: every forced ``cam_trans`` against
  ``__graft_entry__._build``'s forward on the same weights, to
  ``tests/test_torch_port_stream.py``'s tolerances (rtol 2e-3, atol
  1e-3); the port's FLOP and byte counts of that forward are printed
  beside XLA's cost analysis (``pytest -s``), not compared;
* the counters: the FLOP count of the network equals a count from its
  layers' shapes taken by forward hooks, and the byte count of one conv
  equals a hand count;
* ``_measure_stream_loop``, ``_measure_dp`` on two CPU replicas, the
  peak table, and every entry point raising without a card.

Every checkpoint a test writes lies under its ``tmp_path``. Importing
this module makes sure ``checkpoints/wild.npz``, the file the JAX
package's bench and tools read, exists and holds what
``tools/make_synthetic_checkpoint.py`` writes (``_jax_checkpoint``).
"""

import fcntl
import inspect
import json
import os
import re
import uuid

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as ge
import bench
from acr_tpu_torch import bench as port
from acr_tpu_torch.io.params import save_params_npz
from acr_tpu_torch.models.acr import LocallyConnected
from acr_tpu_torch.pipeline.infer import ACRPipeline
from acr_tpu_torch.tools import dryrun, stream_setup
from acr_tpu_torch.tools.make_synthetic_checkpoint import make_params
from acr_tpu_torch.utils import device as device_mod
from tools import make_synthetic_checkpoint as jax_make_checkpoint

torch.set_num_threads(2)
SMALL = 128
RTOL, ATOL = 2e-3, 1e-3            # tests/test_torch_port_stream.py
H100 = "NVIDIA H100 80GB HBM3"


def _jax_checkpoint(path=ge.CKPT):
    """Write JAX's synthetic checkpoint (``tools/make_synthetic_checkpoint
    .py``, seed 0) to ``path`` where it is absent: under an exclusive lock
    beside it, into a unique temporary name that ``os.replace`` then moves
    onto ``path``. ``__graft_entry__._ensure_assets`` writes the file in
    place, so a test that found it absent could read another process's
    partial write, and a test that reads it without that call fails where
    it is absent; every test process imports this module before it runs a
    test, so the file is whole before any test reads it."""
    if os.path.exists(path):
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return
        tmp = f"{path}.{uuid.uuid4().hex}.tmp.npz"
        try:
            jax_make_checkpoint.main(["--out", tmp])
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


_jax_checkpoint()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench") / "wild.npz")
    save_params_npz(path, make_params(0))
    return path


def test_jax_checkpoint_is_the_tools_output(tmp_path):
    made = str(tmp_path / "made.npz")
    _jax_checkpoint(made)
    _jax_checkpoint(made)                   # present: left as it is
    assert sorted(os.listdir(tmp_path)) == ["made.npz", "made.npz.lock"]
    with np.load(ge.CKPT) as got, np.load(made) as want:
        assert got.files == want.files
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---- main: the calls and the line ----

def _jax_roofline_keys():
    """The keys of JAX's roofline, from ``bench._measure``'s source."""
    src = inspect.getsource(bench._measure)
    return re.findall(r'"(\w+)":', src[src.index('r["roofline"] = {'):])


RENAMED = {"mxu_util_pct": "mfu_pct"}


def _recorder(calls, name, original, result):
    """``original``'s stand-in: records (name, the bound arguments with
    defaults, less ``device`` and ``model_path``) and returns
    ``result(arguments)``."""
    sig = inspect.signature(original)

    def record(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        a = dict(bound.arguments)
        a.pop("device", None), a.pop("model_path", None)
        calls.append((name, a))
        return result(a)
    return record


def _measured(roofline):
    def result(a):
        r = {"fps": 10.0 * a["batch"], "fps_uncorrected": 9.0,
             "readback_ms": 0.5}
        if a["roofline"]:
            r["roofline"] = roofline(a)
        return r
    return result


def _stream(card):
    def result(a):
        if a["render_size"] == 2048:
            raise ValueError("no 2048 px render here")
        tag = a["tag"]
        r = {f"stream_step_ms_b1{tag}": 1.0, f"stream_step_ms_b1{tag}_p50": 1.0,
             f"stream_step_ms_b1{tag}_p90": 2.0,
             f"stream_readback_ms{tag}": 0.1}
        return dict(r, **card)
    return result


def _loop(a):
    return {"stream_loop_p50_ms": 3.0, "stream_loop_p90_ms": 4.0,
            "stream_loop_frames": a["n_frames"]}


def _dp(a):
    return {"fps": 5.0, "devices": a["dp"], "batch": a["batch"],
            "input_size": int(os.environ.get("ACR_BENCH_SIZE", "512"))}


def _port_roofline(a):
    """The port's real ``_roofline`` on a small product, as on the card."""
    return port._roofline(lambda x: x @ x, (torch.ones(4, 4),), 10.0,
                          a["batch"], a["precision"], torch.device("cuda"))


MODES = {
    "default": {},
    "precision_batch": {"ACR_BENCH_PRECISION": "fp32",
                        "ACR_BENCH_BATCH": "4"},
    "quant": {"ACR_BENCH_QUANT": "int8"},
    "dp": {"ACR_BENCH_DP": "2", "ACR_BENCH_SIZE": "64"},
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_main_makes_jax_calls(mode, monkeypatch, capsys):
    for k in ("ACR_BENCH_PRECISION", "ACR_BENCH_BATCH", "ACR_BENCH_QUANT",
              "ACR_BENCH_DP", "ACR_BENCH_SIZE"):
        monkeypatch.delenv(k, raising=False)
    env = dict(MODES[mode], ACR_BENCH_PLATFORM="cpu", ACR_BENCH_ITERS="3",
               ACR_BENCH_REPS="2")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = {"jax": [], "port": []}
    jax_keys = _jax_roofline_keys()
    monkeypatch.setattr(ge, "_ensure_assets", lambda: None)
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    monkeypatch.setattr(dryrun, "_ensure_assets", lambda *a: None)
    monkeypatch.setattr(port, "card_peaks",
                        lambda d: device_mod.PEAKS[H100])
    for side, mod, stream_mod, stream_name, card in (
            ("jax", bench, bench, "_measure_stream_b1", {}),
            ("port", port, stream_setup, "measure_stream_b1",
             {"card": "cpu"})):
        roofline = ((lambda a: dict.fromkeys(jax_keys, 1.0))
                    if side == "jax" else _port_roofline)
        for name, result in (("_measure", _measured(roofline)),
                             ("_measure_stream_loop", _loop),
                             ("_measure_dp", _dp)):
            monkeypatch.setattr(mod, name, _recorder(
                calls[side], name, getattr(mod, name), result))
        monkeypatch.setattr(stream_mod, stream_name, _recorder(
            calls[side], "stream_b1", getattr(stream_mod, stream_name),
            _stream(card)))

    bench.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = port.main()
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == got

    assert calls["port"] == calls["jax"]
    # the headline, 2 fp32 b1 reps, 4 stream variants, the loop, int8 b16
    n = {"default": 1 + 2 + 4 + 1 + 1}.get(mode, 1)
    assert len(calls["jax"]) == n
    assert set(got) == set(want) - {"vs_baseline"} | {"card"}
    assert got.pop("card") == "cpu"
    want.pop("vs_baseline")
    w_roof = want["extra"].pop("roofline", None)
    g_roof = got["extra"].pop("roofline", None)
    assert got == want
    if mode == "default":
        assert list(g_roof) == [RENAMED.get(k, k) for k in w_roof]
        assert all(np.isfinite(v) for v in g_roof.values())
        assert got["extra"]["stream_step_ms_b1_2048px"] == \
            "skipped: ValueError"
        assert "no 2048 px render here" in err
    else:
        assert g_roof is w_roof is None and not err


def test_roofline_on_a_card_and_on_the_cpu(monkeypatch):
    peaks = device_mod.PEAKS[H100]
    monkeypatch.setattr(port, "card_peaks", lambda d: peaks)
    x = torch.ones(1024, 1024)
    flops, n_bytes = 2 * 1024 ** 3, 3 * 1024 * 1024 * 4
    steps = 10000.0 / 10                    # 10000 frames/s at batch 10
    r = port._roofline(lambda a: a @ a, (x,), 10000.0, 10, "bf16", "cuda")
    assert r == {
        "gflops_per_step": round(flops / 1e9, 1),
        "hbm_gb_per_step": round(n_bytes / 1e9, 2),
        "achieved_tflops": round(flops * steps / 1e12, 1),
        "mfu_pct": round(100 * flops * steps / peaks["bf16"], 1),
        "apparent_hbm_gbps": round(n_bytes * steps / 1e9, 0),
        "hbm_bound": bool(n_bytes / peaks["bytes_s"]
                          > flops / peaks["bf16"])}
    assert r["mfu_pct"] == 0.2 and r["hbm_bound"] is True
    assert port._roofline(lambda a: a @ a, (x,), 10000.0, 10, "bf16",
                          "cpu") == {k: r[k] for k in ("gflops_per_step",
                                                       "hbm_gb_per_step")}


# ---- the forward against JAX's, and the counts beside XLA's ----

def test_measure_forward_matches_jax(ckpt, monkeypatch):
    monkeypatch.setattr(port, "SIZE", SMALL)
    outs, works = [], []
    build, step_work = dryrun._build, port.step_work

    def recording_build(*args, **kwargs):
        fn, pipe = build(*args, **kwargs)
        assert args[0] == SMALL

        def run(image, offsets):
            out = fn(image, offsets)
            outs.append(out["cam_trans"].numpy().copy())
            return out
        return run, pipe

    def recording_work(*args):
        works.append(step_work(*args))
        return works[-1]
    monkeypatch.setattr(dryrun, "_build", recording_build)
    monkeypatch.setattr(port, "step_work", recording_work)
    r = port._measure("fp32", 2, 2, roofline=True, device="cpu",
                      model_path=ckpt)
    assert list(r) == ["fps", "fps_uncorrected", "readback_ms", "roofline"]
    assert all(np.isfinite(r[k]) and r[k] > 0 for k in list(r)[:3])
    assert list(r["roofline"]) == ["gflops_per_step", "hbm_gb_per_step"]
    # 4 warm-up calls, 1 timed readback, 2 timed calls, the counted call
    assert len(outs) == 8 and len(works) == 1

    monkeypatch.setattr(ge, "CKPT", ckpt)
    fn, _ = ge._build(SMALL, "fp32")
    image, offsets = (t.numpy() for t in dryrun.example_inputs(2, SMALL))
    compiled = jax.jit(fn).lower(image.reshape(2, SMALL, -1),
                                 offsets).compile()
    want = np.asarray(compiled(image.reshape(2, SMALL, -1),
                               offsets)["cam_trans"])
    for got in outs:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert float(got.sum()) == pytest.approx(float(want.sum()),
                                                 rel=RTOL, abs=ATOL)
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    (flops, n_bytes), = works
    print(f"\n# forward at {SMALL} px, b2, fp32: the port counts {flops} "
          f"FLOPs and {n_bytes} bytes; XLA's cost analysis "
          f"{ca['flops']:.0f} FLOPs and {ca['bytes accessed']:.0f} bytes; "
          f"XLA / port: {ca['flops'] / flops:.4f} (FLOPs), "
          f"{ca['bytes accessed'] / n_bytes:.4f} (bytes)")


# ---- the counters ----

def test_flop_count_equals_the_layers_shapes(ckpt):
    """FlopCounterMode over the network against 2 x the multiply-adds of
    its Conv2d, Linear and LocallyConnected layers, from their output
    shapes by forward hooks, plus the two attention poolings' batched
    products (32 parts x the pooled maps' C x H x W, from the pooled
    convs' outputs)."""
    pipe = ACRPipeline(dryrun._config(64, model_path=ckpt), device="cpu")
    net = pipe.net
    count, pooled = [0], []

    def hook(m, inp, out):
        if isinstance(m, torch.nn.Conv2d):
            k = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
        elif isinstance(m, torch.nn.Linear):
            k = m.in_features
        else:
            k = m.w.shape[1]
        count[0] += 2 * out.numel() * k
    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear,
                                 LocallyConnected))]
    handles += [m.register_forward_hook(lambda m, i, o: pooled.append(o.numel()))
                for m in (net.contact_conv, net.cam_shape_conv)]
    image, _ = dryrun.example_inputs(2, 64)
    try:
        with torch.no_grad():
            flops, _ = port.step_work(net, (image,), 2)
    finally:
        for h in handles:
            h.remove()
    assert len(pooled) == 2
    assert flops == count[0] + sum(2 * 32 * n for n in pooled) > 0


def test_byte_count_one_conv():
    conv = torch.nn.Conv2d(3, 5, 3, padding=1)
    x = torch.randn(2, 3, 8, 8)
    with torch.no_grad():
        flops, n_bytes = port.step_work(conv, (x,), 1)
    out_numel = 2 * 5 * 8 * 8
    assert flops == 2 * out_numel * 3 * 9
    assert n_bytes == 4 * (x.numel() + conv.weight.numel()
                           + conv.bias.numel() + out_numel)
    # views, aliases and allocations move nothing; an in-place op reads
    # and writes its operand
    assert port.step_work(lambda a: a.t()[:3].unsqueeze(0), (x.view(6, 64),),
                          1) == (0, 0)
    assert port.step_work(lambda a: torch.empty_like(a), (x,), 1) == (0, 0)
    assert port.step_work(lambda a: a.mul_(2), (x,), 1) == \
        (0, 2 * 4 * x.numel())


def test_step_work_adds_the_fused_kernels_launches(monkeypatch):
    from acr_tpu_torch.ops import mano_kernel
    monkeypatch.setitem(mano_kernel.LAUNCHES, "mano_fused", 0)

    def launch(a):
        mano_kernel.LAUNCHES["mano_fused"] += 2
        return a
    x = torch.ones(3)
    k_bytes, k_flops = mano_kernel.fused_work(8)
    assert port.step_work(launch, (x,), 8) == (2 * k_flops, 2 * k_bytes)


# ---- the other measurements ----

def test_measure_stream_loop_on_the_cpu(ckpt):
    r = port._measure_stream_loop(2, device="cpu", model_path=ckpt)
    assert list(r) == ["stream_loop_p50_ms", "stream_loop_p90_ms",
                       "stream_loop_frames"]
    assert r["stream_loop_frames"] == 2
    assert all(np.isfinite(v) and v > 0 for v in r.values())


def test_measure_dp_on_two_cpu_replicas(ckpt, monkeypatch):
    monkeypatch.setenv("ACR_BENCH_SIZE", "64")
    replicas = []
    run_sharded = ACRPipeline.run_sharded

    def recording(self, *args):
        replicas.append([str(r.device) for r in self.replicas])
        return run_sharded(self, *args)
    monkeypatch.setattr(ACRPipeline, "run_sharded", recording)
    r = port._measure_dp(2, "fp32", 2, 1, device="cpu", model_path=ckpt)
    assert r["devices"] == 2 and r["batch"] == 2 and r["input_size"] == 64
    assert np.isfinite(r["fps"]) and r["fps"] > 0
    assert replicas == [["cpu", "cpu"]] * 4


def test_measure_dp_never_repeats_a_card(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=r"ACR_BENCH_DP=2 needs 2 cards, "
                       r"have 1 \(set ACR_BENCH_PLATFORM=cpu"):
        port._measure_dp(2, "bf16", 16, 1, device="cuda", model_path=ckpt)


def test_card_peaks(monkeypatch):
    lines = {"cuda": f"{H100}, 700.00 W",
             "cuda:1": "NVIDIA A100-SXM4-80GB, 400.00 W"}
    monkeypatch.setattr(device_mod, "card_line", lambda d: lines.get(d, "cpu"))
    assert device_mod.card_peaks("cuda") == {
        "bf16": 989.4e12, "fp32": 66.9e12, "bytes_s": 3.35e12}
    with pytest.raises(ValueError, match="A100-SXM4-80GB"):
        device_mod.card_peaks("cuda:1")
    with pytest.raises(ValueError, match="'cpu'"):
        device_mod.card_peaks("cpu")


@pytest.mark.parametrize("entry", [
    lambda p: port.main(),
    lambda p: port._measure("bf16", 8, 1, model_path=p),
    lambda p: port._measure_stream_loop(1, model_path=p),
    lambda p: port._measure_dp(2, "bf16", 16, 1, model_path=p),
], ids=["main", "measure", "measure_stream_loop", "measure_dp"])
def test_entry_points_raise_without_a_card(ckpt, entry, monkeypatch):
    monkeypatch.delenv("ACR_BENCH_PLATFORM", raising=False)
    monkeypatch.setattr(dryrun, "_ensure_assets", lambda *a: None)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry(ckpt)
