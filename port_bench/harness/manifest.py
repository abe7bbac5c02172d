"""``BENCHMARK.json`` and the files it names.

A cell's configuration is ``configs/<config>.json``, whose
``architecture`` names ``archs/<architecture>.py`` (``load_arch``), its
traffic mix ``traffic/<traffic>.json`` and each metric
``metrics/<name>.py``, a module with ``read(obs) -> float | None``.
Nothing here names a cell, a mix, a metric or an architecture: a new one
is a new file and a new entry.
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


def arch_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "archs", f"{name}.py")


def load_arch(name: str):
    """The module ``archs/<name>.py``: everything of a run that is the
    architecture's, which the harness reaches only through it.

    - ``make_weights(seed, device, dtype, fields)``: the seeded weights on
      ``device`` in the served ``dtype``, as the program loads them;
      ``fields`` are the app's config fields of the cell.
    - ``KEEP``: the keys of the program's outputs that the drivers copy to
      the host for the judge.
    - ``Reference(weights, fields, mano_dir, device, tf32=False,
      tail_bf16=False)``: the frozen reference, float32 with TF32 off;
      ``tf32`` and ``tail_bf16`` lower its precision for the control. It
      has ``.faces`` (2, F, 3), ``.sequence(frames, picks=None)`` (the
      outputs of a sequence of BGR frames, one array per key with the
      frame axis first) and ``.composite(ref_out, t, geometry, bgr)`` (the
      delivered frame it draws for frame ``t`` from one frame's
      ``verts``, ``cam_trans`` and ``detection_flag``).
    - ``new_numbers()`` and ``judge_sequence(ref, frames, outputs, judged,
      composites, numbers, fields)``: the numbers that the configuration's
      ``limits`` name, widened by one sequence; it returns the
      reference's outputs.
    - ``flops_per_frame(fields)``: the network's operations per frame.
    - ``as_outputs(ref_out, t, fields)``: frame ``t`` of the reference's
      outputs shaped as the program's, for the reduced-precision control.

    Every MANO-based architecture provides, in the program's outputs
    (``KEEP``) and the reference's, ``verts`` (hand, vertex, 3; metres,
    root-aligned) and ``cam_trans`` (hand, 3) and ``detection_flag``
    (hand), which the harness's generic steps read: the rasterizer's work
    (``run._raster_work``), the composite and the faults of
    ``control``.
    """
    spec = importlib.util.spec_from_file_location(
        f"port_bench_arch_{name}", arch_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(manifest: Dict, workload: str) -> Dict:
    """The workload entry, its configuration, the configuration's
    architecture (``arch``, the loaded module) and traffic, and the
    metrics it reports: ``end_to_end`` (with ``--trace 0``) and
    ``per_layer`` (with ``--trace 1``)."""
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
    config = load_config(w["config"])
    if "architecture" not in config:
        raise KeyError(f"{os.path.join(BENCH_DIR, 'configs', w['config'] + '.json')} "
                       "has no 'architecture', the name of its archs/<name>.py")
    return {"workload": w, "config": config,
            "arch": load_arch(config["architecture"]),
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
