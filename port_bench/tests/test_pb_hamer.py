"""The HaMeR configuration (``archs/hamer.py``, ``reference/hamer.py``)
on the CPU at a small width: a sound run is correct and the control and
the faults are not; the FLOP counts and the attention work at the
published widths; the new metrics' readers."""

import pytest
import torch

from port_bench import control
from port_bench.harness import manifest
from port_bench.reference import hamer as ref

HAMER = manifest.load_arch("hamer")
ACR = manifest.load_arch("acr")
SMALL = dict(crop=64, crop_w=48, width=64, depth=2, heads=4, mlp=256,
             dec_width=32, dec_depth=1, dec_heads=2, dec_head_dim=16,
             dec_mlp=32)


@pytest.fixture
def small_hamer(monkeypatch, small_cell):
    """The cell at the CPU size, HaMeR at ``SMALL`` in the reference and
    in the program."""
    from acr_tpu_torch.models import hamer as program
    monkeypatch.setattr(ref, "DIMS", ref.Dims(**SMALL))
    monkeypatch.setattr(program, "DIMS", program.Dims(**SMALL))
    return small_cell("webcam_hamer_fp32_tracking")


def test_weights_are_acrs_and_hamers(small_hamer):
    fields = small_hamer["config"]["model"]
    w = HAMER.make_weights(2 ** 31 + 3, "cpu", torch.float32, fields)
    acr = ACR.make_weights(2 ** 31 + 3, "cpu", torch.float32, fields)
    hamer = {k[len("hamer."):]: v for k, v in w.items() if k.startswith("hamer.")}
    assert {k: v.shape for k, v in w.items() if k in acr} == \
        {k: v.shape for k, v in acr.items()}
    assert all(torch.equal(w[k], v) for k, v in acr.items())
    assert {k: tuple(v.shape) for k, v in hamer.items()} == \
        dict(ref.param_shapes(ref.DIMS))
    assert len(w) == len(acr) + len(hamer)
    assert torch.equal(hamer["mano_head.init_cam"], torch.tensor([HAMER.SCENE["cam"]]))


def test_sound_run_is_correct_and_control_and_faults_are_not(small_hamer):
    got = control.readings(small_hamer, 2 ** 31 + 99, 3.0, "cpu")
    assert got["sound"]["correct"], got["sound"]
    assert set(got["sound"]["numbers"]) == {
        "hands_wrong", "center_gap", "center_err", "box_px", "params_err",
        "verts_m", "cam_mesh_m", "pj2d_px"}
    assert set(got["controls"]) == {"reduced", "altered", "frozen"}
    for name, c in got["controls"].items():
        assert not c["correct"], (name, c)
    assert set(got["metrics"]) == {"frame_latency_p50_ms",
                                   "frame_latency_p95_ms", "setup_s"}


def test_flops_and_attention_work_at_the_published_widths():
    flops = HAMER.regressor_flops()
    # two crops of 192 tokens through 32 blocks of width 1280 (the linear
    # layers and the attention products) and the decoder: about 0.5 TFLOP
    assert 490e9 < flops < 510e9
    assert HAMER.flops_per_frame({"input_size": 512}) == 102119284736 + flops
    assert ACR.flops_per_frame({"input_size": 512}) == 102119284736
    assert HAMER.attention_work() == {"flops": 2 * 16 * 192 * 192 * 80 * 4,
                                      "bytes": 4 * 4 * 2 * 16 * 192 * 80}


class Obs:
    precision = "fp32"
    peaks = {"fp32": 66.9e12, "bytes_s": 3.35e12}
    trace = {"annotations": {"port_bench.issue": {"count": 4, "device_s": 0.06},
                             "port_bench.forward": {"count": 4, "device_s": 0.05}},
             "kernels": {"fmha_cutlassF_f32_aligned_64x128_rf_sm80(...)": {
                 "count": 10, "seconds": 10 * 11.28e-6},
                 "fmha_cutlassF_f32_aligned_64x64_rf_sm80(...)": {
                     "count": 4, "seconds": 1.0},
                 "sgemm": {"count": 1, "seconds": 1.0}}}


def test_regressor_metrics_read_the_trace():
    read = manifest.load_reader
    assert read("regress_device_ms.webcam")(Obs()) == pytest.approx(15.0)
    assert read("regress_mfu_pct.webcam")(Obs()) == pytest.approx(
        100 * HAMER.regressor_flops() / 15e-3 / 66.9e12)
    bound = max(377487360 / 66.9e12, 7864320 / 3.35e12)
    assert read("attention_roofline_pct.webcam")(Obs()) == pytest.approx(
        100 * bound / 11.28e-6)
    empty = Obs()
    empty.trace = None
    for name in ("regress_device_ms.webcam", "regress_mfu_pct.webcam",
                 "attention_roofline_pct.webcam"):
        assert read(name)(empty) is None
