"""Shared fixtures of the benchmark's own tests (CPU; ``cuda``-marked
tests decide inside the test whether a card is present)."""

import pytest

from port_bench.harness import manifest

# the CPU size of a run: the published widths at a 128 px input
SMALL_MODEL = {"input_size": 128, "centermap_size": 16, "render_size": 128}
SMALL_TRAFFIC = {"clips": 1, "frames_per_clip": 24, "width": 320,
                 "height": 180, "warm_frames": 8, "pool": 8}


# folder mode has no cell in BENCHMARK.json yet: its driver is held here
# on the fp32 configuration and the folder traffic files
FRAMES_PER_S = {"name": "frames_per_s", "unit": "frames/s", "better": "higher",
                "bound": 0.25, "source": "host_clock"}


@pytest.fixture
def small_cell():
    """``manifest.cell`` at the CPU size: the cell's own files, with the
    input, map and render sizes and the frames cut down. Given a
    ``traffic``, a cell of the fp32 configuration and that traffic file,
    reporting ``frames_per_s`` and ``setup_s``."""
    def make(name, traffic=None):
        b = manifest.load_manifest()
        if traffic is not None:
            b = {"workloads": [{"name": name, "config": "acr_w32_fp32",
                                "traffic": traffic, "chips": 1, "why": "a test"}],
                 "end_to_end": [FRAMES_PER_S] + [
                     m for m in b["end_to_end"] if m["name"] == "setup_s"],
                 "per_layer": []}
        # the configuration and traffic are read anew from their files
        cell = manifest.cell(b, name)
        cell["traffic"].update(SMALL_TRAFFIC)
        cell["config"]["model"].update(SMALL_MODEL)
        return cell
    return make
