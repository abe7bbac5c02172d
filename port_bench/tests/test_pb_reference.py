"""The frozen reference against the port at a small size on the CPU, and
``correct`` coming out false when the timed path is broken underneath or
replaced by the reduced-precision control."""

import collections

import pytest
import torch

from port_bench import control
from port_bench.harness import manifest
from port_bench.reference import network
from port_bench.run import run_cell

ACR = manifest.load_arch("acr")


def make_weights(seed, device, input_size):
    return ACR.make_weights(seed, device, torch.float32,
                            {"input_size": input_size})


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


def test_run_and_control_take_the_architecture_from_the_cell(small_cell):
    """``run_cell`` and ``control.reduced_control`` reach the weights, the
    kept output keys, the reference, the judge and the FLOP count only
    through the cell's architecture module."""
    cell = small_cell("webcam_fp32_tracking")
    arch = cell["arch"] = manifest.load_arch("acr")    # a fresh module to spy on
    calls, returned = collections.Counter(), {}

    def spy(name):
        real = getattr(arch, name)

        def called(*a, **k):
            calls[name] += 1
            returned[name] = real(*a, **k)
            return returned[name]
        return called
    for name in ("make_weights", "Reference", "new_numbers", "judge_sequence",
                 "as_outputs"):
        setattr(arch, name, spy(name))

    class Keep(tuple):
        def __iter__(self):
            calls["KEEP"] += 1
            return super().__iter__()
    arch.KEEP = Keep(arch.KEEP)

    def flops_per_frame(fields):
        calls["flops_per_frame"] += 1
        return 12345
    arch.flops_per_frame = flops_per_frame
    stash = {}
    r = _run(cell, stash=stash)
    assert r["correct"], r["checks"]
    run = stash["run"]
    assert run.weights is returned["make_weights"]
    assert stash["ref"] is returned["Reference"]
    assert run.obs.work["flops_per_frame"] == 12345
    assert calls["KEEP"] >= r["attempted"] > 0
    assert calls["judge_sequence"] == calls["new_numbers"] == 1
    assert "as_outputs" not in calls
    control.reduced_control(stash)
    assert returned["Reference"].tail_bf16 and returned["Reference"].tf32
    assert calls["Reference"] == calls["judge_sequence"] == calls["new_numbers"] == 2
    assert calls["as_outputs"] == len(stash["seen"]["sequences"][0]["frames"])


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
    cell = manifest.cell(manifest.load_manifest(), "webcam_fp32_tracking")
    r = run_cell(cell, 2 ** 31 + 1, 3.0, False, "cuda")
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
