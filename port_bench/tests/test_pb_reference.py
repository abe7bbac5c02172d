"""The frozen reference against the port at a small size on the CPU, and
``correct`` coming out false when the timed path is broken underneath or
replaced by the reduced-precision control."""

import pytest
import torch

from port_bench import control
from port_bench.harness.weights import make_weights
from port_bench.reference import network
from port_bench.run import run_cell


def test_reference_network_matches_the_port_forward():
    from acr_tpu_torch.models.acr import ACRNet
    weights = make_weights(2 ** 31 + 77, "cpu", input_size=128)
    net = ACRNet().eval()
    net.load_state_dict(weights, strict=True)
    image = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        port = net(image)
        ref = network.forward(network.Params(weights), image)
    for k, v in ref.items():
        assert torch.allclose(port[k], v, rtol=0, atol=2e-6), k
    assert set(n for n, _ in network.param_shapes(128)) == set(net.state_dict())


def test_scene_detects_both_hands():
    weights = make_weights(5, "cpu", input_size=128)
    image = torch.randint(0, 256, (1, 128, 128, 3), dtype=torch.uint8)
    with torch.no_grad():
        maps = network.forward(network.Params(weights), image)
    for side in "lr":
        assert maps[f"{side}_center_map"].max() > 0.35


def _run(cell, seconds=3.0, **kw):
    return run_cell(cell, 2 ** 31 + 99, seconds, False, "cpu", **kw)


def test_sound_webcam_run_is_correct(small_cell):
    r = _run(small_cell("webcam_fp32_overlay"))
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"frame_latency_p50_ms", "frame_latency_p95_ms",
                                 "setup_s"}


def test_sound_folder_run_is_correct(small_cell):
    r = _run(small_cell("folder_fp32_b8_params", "folder_params"), seconds=4.0)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}


def test_altered_answer_is_not_correct(small_cell):
    r = _run(small_cell("webcam_fp32_tracking"), app_hook=control.altered)
    assert not r["correct"]
    assert r["checks"]["verts_m"]["number"] > r["checks"]["verts_m"]["limit"]


def test_state_left_unchanged_is_not_correct(small_cell):
    """A stream step that leaves the OneEuro state as it found it."""
    r = _run(small_cell("webcam_fp32_tracking"), app_hook=control.frozen)
    assert not r["correct"]


def test_half_of_the_batch_left_out_is_not_correct(small_cell):
    """A chunk step whose second half of the chunk repeats the first."""
    cell = small_cell("folder_fp32_b8_overlay", "folder_overlay")
    assert set(control.faults(cell)) == {"altered", "frozen", "halved"}
    assert _run(cell, seconds=4.0)["correct"]
    r = _run(cell, seconds=4.0, app_hook=control.halved)
    assert not r["correct"]


def test_reduced_precision_control_is_not_correct(small_cell):
    """``port_bench.control``'s readings of one seed: the sound run is
    correct, and the reduced-precision control and each fault of the cell
    are not, by the cell's own verdict."""
    cell = small_cell("webcam_fp32_overlay")
    got = control.readings(cell, 2 ** 31 + 99, 3.0, "cpu")
    assert got["sound"]["correct"], got["sound"]
    assert set(got["controls"]) == {"reduced", "altered", "frozen"}
    for name, c in got["controls"].items():
        assert not c["correct"], (name, c)


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from port_bench.harness import manifest
    cell = manifest.cell(manifest.load_manifest(), "webcam_fp32_tracking")
    r = run_cell(cell, 2 ** 31 + 1, 3.0, False, "cuda")
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
