"""What the harness loads: nothing of JAX or the JAX package in any of
its modules, and nothing of the program in the reference or in an
architecture's module (``archs/*.py``), which reaches the reference."""

import json
import os
import subprocess
import sys

from port_bench.harness import manifest

FORBIDDEN = ["jax", "jaxlib", "flax", "orbax", "acr_tpu", "bench",
             "__graft_entry__", "tools"]

PROBE = r"""
import glob, json, os, sys
import port_bench.run, port_bench.control
from port_bench.harness import drivers, frames, judge, manifest, readers, trace, work
b = manifest.load_manifest()
for c in b["configs"]:
    json.load(open(os.path.join(manifest.ROOT, c["file"])))
for w in b["workloads"]:
    manifest.load_traffic(w["traffic"])
for m in b["end_to_end"] + b["per_layer"]:
    manifest.load_reader(m["name"])
for p in glob.glob(manifest.arch_path("*")):
    manifest.load_arch(os.path.basename(p)[:-3])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REF_PROBE = r"""
import json, sys
from port_bench.reference import camera, host, mano, network, parse, render, temporal
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


ARCH_PROBE = r"""
import glob, json, os, sys
from port_bench.harness import manifest
names = sorted(os.path.basename(p)[:-3] for p in glob.glob(manifest.arch_path("*")))
for name in names:
    manifest.load_arch(name)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules} | {"arch:" + n for n in names})))
"""


def _tops(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=manifest.ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_nothing_of_jax_or_the_jax_package():
    tops = _tops(PROBE)
    assert "port_bench" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    tops = _tops(REF_PROBE)
    assert "acr_tpu_torch" not in tops
    assert not tops & set(FORBIDDEN)


def test_architectures_load_nothing_of_jax_or_the_program():
    """Each ``archs/<name>.py`` and the reference it reaches, loaded alone."""
    tops = _tops(ARCH_PROBE)
    assert "arch:acr" in tops
    assert "acr_tpu_torch" not in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)
