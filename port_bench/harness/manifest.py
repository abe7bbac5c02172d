"""``BENCHMARK.json`` and the files it names.

A cell's configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json`` and each metric ``metrics/<name>.py``, a
module with ``read(obs) -> float | None``. Nothing here names a cell,
a mix or a metric: a new one is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_manifest(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(*parts: str) -> Dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def load_config(name: str) -> Dict:
    return _load_json("configs", f"{name}.json")


def load_traffic(name: str) -> Dict:
    return _load_json("traffic", f"{name}.json")


def metric_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "metrics", f"{name}.py")


def load_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{name.replace('.', '_')}", metric_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(manifest: Dict, workload: str) -> Dict:
    """The workload entry, its configuration and traffic, and the metrics
    it reports: ``end_to_end`` (with ``--trace 0``) and ``per_layer``
    (with ``--trace 1``)."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    return {"workload": w, "config": load_config(w["config"]),
            "traffic": load_traffic(w["traffic"]),
            "end_to_end": e2e, "per_layer": layer}


def read_metrics(entries: List[Dict], obs) -> Dict[str, Dict]:
    """Each metric's reader over the run's observations; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in entries:
        value = load_reader(m["name"])(obs)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
