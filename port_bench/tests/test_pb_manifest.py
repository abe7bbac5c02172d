"""BENCHMARK.json against the contract's shapes, and the harness finding
configurations, traffic mixes and metrics by name alone."""

import json
import os
import re
import shutil

import pytest

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
        assert c["file"].startswith("port_bench/") and c["reduced"] == []


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


def test_new_files_need_no_edit(tmp_path, monkeypatch):
    """A configuration, a traffic mix and a metric dropped into place, and
    their entries, are found without an edit to any file there."""
    bench_dir = tmp_path / "port_bench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(manifest.BENCH_DIR, sub), bench_dir / sub)
    cfg = json.loads((bench_dir / "configs" / "acr_w32_fp32.json").read_text())
    cfg["name"] = "acr_w32_fp32_far"
    (bench_dir / "configs" / "acr_w32_fp32_far.json").write_text(json.dumps(cfg))
    tr = json.loads((bench_dir / "traffic" / "webcam_tracking.json").read_text())
    tr["fps"] = 60
    (bench_dir / "traffic" / "webcam_60fps.json").write_text(json.dumps(tr))
    (bench_dir / "metrics" / "frames_seen.webcam.py").write_text(
        "def read(obs):\n    return obs.delivered\n")
    b = _bench()
    b["configs"].append(dict(b["configs"][0], name="acr_w32_fp32_far",
                             file="port_bench/configs/acr_w32_fp32_far.json"))
    b["workloads"].append({"name": "webcam_fp32_60fps", "config": "acr_w32_fp32_far",
                           "traffic": "webcam_60fps", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] in ("frame_latency_p50_ms", "frame_latency_p95_ms"):
            m["workloads"].append("webcam_fp32_60fps")
    b["per_layer"].append({"name": "frames_seen.webcam", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "a test", "moves": "frame_latency_p50_ms",
                           "workloads": ["webcam_fp32_60fps"]})
    monkeypatch.setattr(manifest, "BENCH_DIR", str(bench_dir))
    cell = manifest.cell(b, "webcam_fp32_60fps")
    assert cell["traffic"]["fps"] == 60
    assert cell["config"]["name"] == "acr_w32_fp32_far"
    assert [m["name"] for m in cell["per_layer"]] == ["frames_seen.webcam"]

    class Obs:
        delivered, window_s, latencies_ms = 42, 2.0, [1.0]
        setup_s = 3.0
    got = manifest.read_metrics(cell["per_layer"] + cell["end_to_end"], Obs())
    assert got["frames_seen.webcam"]["value"] == 42.0
    assert got["frame_latency_p50_ms"]["value"] == 1.0
    with pytest.raises(KeyError):
        manifest.cell(b, "no_such_cell")
