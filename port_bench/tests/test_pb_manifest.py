"""BENCHMARK.json against the contract's shapes, and the harness finding
configurations, architectures, traffic mixes and metrics by name alone."""

import ast
import glob
import hashlib
import json
import os
import re
import shutil
import sys

import numpy as np
import pytest

import port_bench.reference

from port_bench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _bench():
    return manifest.load_manifest()


def test_keys_names_and_units():
    b = _bench()
    assert set(b) == TOP
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in b["end_to_end"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/")
        # the model-configs guide's cuts of depth and share are listed here
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
        assert all(isinstance(k, str) and NAME.match(k) for k in c["reduced"])
        with open(os.path.join(manifest.ROOT, c["file"])) as f:
            arch = json.load(f)["architecture"]
        assert NAME.match(arch) and os.path.exists(manifest.arch_path(arch)), c


def test_every_cell_reports_what_its_layers_move():
    b = _bench()
    for w in b["workloads"]:
        cell = manifest.cell(b, w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"], w["name"]
        for m in cell["per_layer"]:
            assert m["moves"] in e2e, (w["name"], m["name"])
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(manifest.metric_path(m["name"])), m["name"]
        assert callable(manifest.load_reader(m["name"]))


def test_check_fits_the_time_of_a_full_check():
    b = _bench()
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


# a second architecture as it would come: its module, its reference and
# a configuration that names it (a mesh linear in the frame's mean colour)
TOY_REFERENCE = '''"""A toy hand-mesh reference."""
import numpy as np


def mesh(frames, w):
    x = np.stack([f.reshape(-1, 3).mean(0) for f in frames])
    return np.einsum("tc,hcv->thv", x, w).reshape(len(frames), 2, -1, 3)
'''

TOY_ARCH = '''"""A toy architecture, held to the interface of load_arch."""
import numpy as np
import torch

from port_bench.reference import toy_mesh

KEEP = ("verts", "cam_trans", "detection_flag")


def make_weights(seed, device, dtype, fields):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {"w": torch.randn(2, 3, fields["vertices"] * 3, generator=gen,
                             device=device).to(dtype)}


class Reference:
    def __init__(self, weights, fields, mano_dir, device, tf32=False,
                 tail_bf16=False):
        self.w = weights["w"].float().cpu().numpy()
        self.faces = np.zeros((2, 1, 3), np.int64)

    def sequence(self, frames, picks=None):
        verts = toy_mesh.mesh(frames, self.w)
        return {"verts": verts, "cam_trans": np.zeros(verts.shape[:2] + (3,)),
                "detection_flag": np.ones(verts.shape[:2], bool)}

    def composite(self, ref_out, t, geometry, bgr):
        return bgr


def new_numbers():
    return {"verts_m": 0.0}


def judge_sequence(ref, frames, outputs, judged, composites, numbers, fields):
    out = ref.sequence(frames)
    for t in judged:
        numbers["verts_m"] = max(numbers["verts_m"], float(
            np.abs(outputs[t]["verts"] - out["verts"][t]).max()))
    return out


def flops_per_frame(fields):
    return 2 * 2 * 3 * fields["vertices"] * 3


def as_outputs(ref_out, t, fields):
    return {k: ref_out[k][t] for k in KEEP}
'''


def _digests(root):
    out = {}
    for path in glob.glob(os.path.join(str(root), "**", "*"), recursive=True):
        if os.path.isfile(path) and "__pycache__" not in path:
            with open(path, "rb") as f:
                out[os.path.relpath(path, str(root))] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_new_files_need_no_edit(tmp_path, monkeypatch):
    """A configuration, an architecture with its reference, a traffic mix
    and a metric dropped into place, and their entries, are found without
    an edit to any file there."""
    import torch
    from port_bench.harness.judge import verdict
    real_dir = manifest.BENCH_DIR
    real = _digests(real_dir)
    manifest.load_arch("acr")   # ACR's references load from their own place
    bench_dir = tmp_path / "port_bench"
    for sub in ("configs", "archs", "reference", "traffic", "metrics"):
        shutil.copytree(os.path.join(manifest.BENCH_DIR, sub), bench_dir / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    copied = _digests(bench_dir)
    cfg = json.loads((bench_dir / "configs" / "acr_w32_fp32.json").read_text())
    cfg["name"] = "acr_w32_fp32_far"
    (bench_dir / "configs" / "acr_w32_fp32_far.json").write_text(json.dumps(cfg))
    tr = json.loads((bench_dir / "traffic" / "webcam_tracking.json").read_text())
    tr["fps"] = 60
    (bench_dir / "traffic" / "webcam_60fps.json").write_text(json.dumps(tr))
    (bench_dir / "metrics" / "frames_seen.webcam.py").write_text(
        "def read(obs):\n    return obs.delivered\n")
    (bench_dir / "reference" / "toy_mesh.py").write_text(TOY_REFERENCE)
    (bench_dir / "archs" / "toy_mesh.py").write_text(TOY_ARCH)
    (bench_dir / "configs" / "toy_mesh_fp32.json").write_text(json.dumps(
        {"name": "toy_mesh_fp32", "architecture": "toy_mesh",
         "model": {"input_size": 8, "vertices": 4}, "limits": {"verts_m": 0.0}}))
    (bench_dir / "configs" / "no_arch.json").write_text(json.dumps(
        {"name": "no_arch", "model": {}, "limits": {}}))
    b = _bench()
    b["configs"].append(dict(b["configs"][0], name="acr_w32_fp32_far",
                             file="port_bench/configs/acr_w32_fp32_far.json"))
    b["configs"].append(dict(b["configs"][0], name="toy_mesh_fp32",
                             file="port_bench/configs/toy_mesh_fp32.json",
                             reduced=["vertices"]))
    b["workloads"].append({"name": "webcam_fp32_60fps", "config": "acr_w32_fp32_far",
                           "traffic": "webcam_60fps", "chips": 1, "why": "a test"})
    b["workloads"].append({"name": "toy_mesh_tracking", "config": "toy_mesh_fp32",
                           "traffic": "webcam_tracking", "chips": 1, "why": "a test"})
    b["workloads"].append({"name": "no_arch_tracking", "config": "no_arch",
                           "traffic": "webcam_tracking", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] in ("frame_latency_p50_ms", "frame_latency_p95_ms"):
            m["workloads"].append("webcam_fp32_60fps")
    b["per_layer"].append({"name": "frames_seen.webcam", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "a test", "moves": "frame_latency_p50_ms",
                           "workloads": ["webcam_fp32_60fps"]})
    monkeypatch.setattr(manifest, "BENCH_DIR", str(bench_dir))
    # a new reference file is found by the package, as in the repository
    monkeypatch.setattr(port_bench.reference, "__path__",
                        [str(bench_dir / "reference")])
    cell = manifest.cell(b, "webcam_fp32_60fps")
    assert cell["traffic"]["fps"] == 60
    assert cell["config"]["name"] == "acr_w32_fp32_far"
    assert "centers" in cell["arch"].KEEP
    assert [m["name"] for m in cell["per_layer"]] == ["frames_seen.webcam"]

    class Obs:
        delivered, window_s, latencies_ms = 42, 2.0, [1.0]
        setup_s = 3.0
    got = manifest.read_metrics(cell["per_layer"] + cell["end_to_end"], Obs())
    assert got["frames_seen.webcam"]["value"] == 42.0
    assert got["frame_latency_p50_ms"]["value"] == 1.0
    with pytest.raises(KeyError):
        manifest.cell(b, "no_such_cell")
    with pytest.raises(KeyError, match="no_arch.json"):
        manifest.cell(b, "no_arch_tracking")

    try:
        toy = manifest.cell(b, "toy_mesh_tracking")
        arch, fields = toy["arch"], toy["config"]["model"]
        assert arch.__file__ == str(bench_dir / "archs" / "toy_mesh.py")
        assert arch.KEEP == ("verts", "cam_trans", "detection_flag")
        assert arch.flops_per_frame(fields) == 144
        weights = arch.make_weights(7, "cpu", torch.float32, fields)
        ref = arch.Reference(weights, fields, None, "cpu")
        frames = [np.full((4, 4, 3), v, np.uint8) for v in (10, 20, 30)]
        out = ref.sequence(frames)
        outputs = [arch.as_outputs(out, t, fields) for t in range(3)]
        for shift, want in ((0.0, True), (1e-4, False)):
            numbers = arch.new_numbers()
            arch.judge_sequence(ref, frames, [dict(o, verts=o["verts"] + shift)
                                              for o in outputs],
                                [0, 1, 2], {}, numbers, fields)
            assert verdict(numbers, toy["config"]["limits"], 3)[0] is want
    finally:
        sys.modules.pop("port_bench.reference.toy_mesh", None)
        if hasattr(port_bench.reference, "toy_mesh"):
            del port_bench.reference.toy_mesh
    # every file that was there is as it was, in the copy and in place
    after = _digests(bench_dir)
    assert {k: after[k] for k in copied} == copied == {k: real[k] for k in copied}
    assert _digests(real_dir) == real


def _imports(tree):
    """Every module an ``import`` names, and ``pkg.name`` for each name a
    ``from pkg import name`` takes."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
            out |= {f"{node.module}.{a.name}" for a in node.names}
    return out


def test_harness_names_nothing_of_an_architecture():
    """The generic code reaches the network and the parser only through
    the cell's architecture module."""
    files = [os.path.join(manifest.BENCH_DIR, n) for n in ("run.py", "control.py")]
    files += glob.glob(os.path.join(manifest.BENCH_DIR, "harness", "*.py"))
    assert len(files) > 4
    for path in files:
        with open(path) as f:
            src = f.read()
        names = _imports(ast.parse(src))
        for mod in ("port_bench.reference.network", "port_bench.reference.parse"):
            assert mod not in names, (path, mod)
        for word in ("centermap_size", "centers_conf", "param_shapes"):
            assert word not in src, (path, word)
