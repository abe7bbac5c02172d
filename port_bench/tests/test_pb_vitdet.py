"""HaMeR's published chain (``archs/hamer_vitdet.py``,
``reference/vitdet.py``, ``reference/vitpose.py``) on the CPU at a small
width: the weights and the scene, a sound run that is correct while the
control and the faults are not, the FLOP counts and kernel work at the
published widths, and the new metrics' readers."""

import pytest
import torch

from port_bench import control
from port_bench.harness import manifest
from port_bench.reference import hamer as rh
from port_bench.reference import vitdet as rv
from port_bench.reference import vitpose as rp

ARCH = manifest.load_arch("hamer_vitdet")
SIZE = 160
DET = dict(width=32, depth=4, heads=2, mlp=64, window=4, global_blocks=(1, 3),
           fpn=16, pre_nms=60, post_nms=50, fc=32, head_convs=2)
POSE = dict(crop=128, crop_w=96, width=32, depth=2, heads=2, mlp=64)
HAMER = dict(crop=64, crop_w=48, width=64, depth=2, heads=4, mlp=256,
             dec_width=32, dec_depth=1, dec_heads=2, dec_head_dim=16, dec_mlp=32)


@pytest.fixture
def small_vitdet(monkeypatch, small_cell):
    """The cell at the CPU size, every network at a small width in the
    references and in the program."""
    from acr_tpu_torch.models import hamer, vitdet, vitpose
    for mod, dims in ((rv, rv.Dims(**DET)), (vitdet, vitdet.Dims(**DET)),
                      (rp, rp.Dims(vit=rh.Dims(**POSE), deconv=16)),
                      (vitpose, vitpose.Dims(vit=hamer.Dims(**POSE), deconv=16)),
                      (rh, rh.Dims(**HAMER)), (hamer, hamer.Dims(**HAMER))):
        monkeypatch.setattr(mod, "DIMS", dims)
    cell = small_cell("webcam_hamer_vitdet_fp32_tracking")
    cell["config"]["model"]["input_size"] = SIZE
    return cell


def test_weights_and_scene(small_vitdet):
    w = ARCH.make_weights(2 ** 31 + 3, "cpu", torch.float32, {"input_size": SIZE})
    shapes = {k: tuple(v.shape) for k, v in w.items()}
    want = {"vitdet." + n: s for n, s in rv.param_shapes(rv.DIMS, SIZE)}
    want.update({"vitpose." + n: s for n, s in rp.param_shapes(rp.DIMS)})
    want.update({"hamer." + n: s for n, s in rh.param_shapes(rh.DIMS)})
    assert shapes == want
    for k in range(3):
        cls = w[f"vitdet.roi_heads.box_predictor.{k}.cls_score.bias"]
        assert cls[0] == ARCH.SCENE["person_logit"] and not cls[1:].any()
    deltas = w["vitdet.proposal_generator.rpn_head.anchor_deltas.bias"].view(-1, 4)
    assert (deltas[:, 3] == ARCH.SCENE["rpn_tall"]).all() and not deltas[:, :3].any()
    for k in range(3):
        box = w[f"vitdet.roi_heads.box_predictor.{k}.bbox_pred.bias"]
        assert box[2:].any() == (k > 0) and not box[:2].any()
    bias = w["vitpose.keypoint_head.final_layer.bias"]
    assert (bias[91:102] == ARCH.SCENE["hand_conf"][0]).all()
    assert (bias[102:112] == ARCH.SCENE["hand_conf"][1]).all() and not bias[:91].any()
    # the deconvolutions upsample bilinearly along the pixels
    k = w["vitpose.keypoint_head.deconv_layers.0.weight"]
    torch.testing.assert_close(k / k[..., 1:2, 1:2], (k / k[..., 1:2, 1:2])[:1, :1].expand_as(k))


@pytest.mark.parametrize("tie", ["objectness", "iou"])
def test_judge_takes_a_near_tie_of_the_rpn(small_vitdet, tie):
    """The program keeps proposal A where the reference's RPN keeps B in
    its place: A is suppressed by C, at an objectness or an IoU within
    the judge's gap of keeping it, and A would suppress B. The judge then
    takes A, with the cascade on A; beyond the gap it does not."""
    import os
    import numpy as np
    fields = dict(small_vitdet["config"]["model"])
    w = ARCH.make_weights(2 ** 31 + 5, "cpu", torch.float32, fields)
    ref = ARCH.Reference(w, fields, os.path.join(manifest.ROOT, "model_data", "mano"), "cpu")
    rgb = torch.as_tensor(np.random.default_rng(5).integers(0, 256, (90, 120, 3), np.uint8))
    d = rv.DIMS
    with torch.no_grad():
        det = rv.detect(ref.D, rgb, SIZE, d)
    # C, A and B, one level of three anchors whose deltas are 0: C over A
    # at an IoU of h / 40, A over B at 0.93, C over B at 0.65
    c, b = [4.0, 4.0, 44.0, 44.0], [4.0, 4.0, 44.0, 30.0]

    def tied(gap):
        iou_gap, obj_gap = (gap, 0.0) if tie == "iou" else (0.0, gap)
        h = 40 * (d.rpn_nms + iou_gap) if tie == "iou" else 40 * 0.9
        a = torch.tensor([4.0, 4.0, 44.0, 4.0 + h])
        boxes = torch.tensor([c, a.tolist(), b])
        logits = torch.tensor([3.0, 3.0 - obj_gap if tie == "objectness" else 2.0, 1.0])
        with torch.no_grad():
            out = rv.redetect(ref.D, dict(det, levels=[(logits, torch.zeros(3, 4), boxes)]), d)
            assert ARCH._near(out["rois"], torch.tensor(b)).any()
            assert not ARCH._near(out["rois"], a).any()
            return a, out, ref._take_proposal(out, a)
    gap = ARCH.IOU_GAP if tie == "iou" else ARCH.RPN_GAP
    a, out, taken = tied(gap / 2)
    assert ARCH._near(taken["rois"], a).any()
    assert not ARCH._near(taken["rois"], torch.tensor(b)).any()
    j = int(torch.nonzero(ARCH._near(taken["rois"], a))[0, 0])
    hw = tuple(det["resized"].shape[1:])
    with torch.no_grad():
        probs, _ = rv.cascade(ref.D, det["feats"], a[None], d, hw)
    torch.testing.assert_close(taken["probs"][j], probs[0])
    a, out, taken = tied(gap * 2)
    assert taken is out


def test_sound_run_is_correct_and_control_and_faults_are_not(small_vitdet, monkeypatch):
    """The sound run is correct; the reduced-precision control, a step that
    freezes the OneEuro state and meshes moved by 0.1 mm are not. The mesh
    is moved where it comes out of the pipeline's refine: this pipeline's
    call returns detections, no mesh."""
    class RefineAltered(control.Altered):
        def __call__(self, *a, **k):
            return self.inner(*a, **k)
    monkeypatch.setattr(control, "altered",
                        lambda app: setattr(app, "pipeline", RefineAltered(app.pipeline)))
    faults = control.faults
    monkeypatch.setattr(control, "faults",
                        lambda cell: dict(faults(cell), altered=control.altered))
    got = control.readings(small_vitdet, 2 ** 31 + 99, 2.0, "cpu")
    assert got["sound"]["correct"], got["sound"]
    assert set(got["sound"]["numbers"]) == set(ARCH.new_numbers())
    assert set(got["controls"]) == {"reduced", "altered", "frozen"}
    for name, c in got["controls"].items():
        assert not c["correct"], (name, c)


def test_flops_and_kernel_work_at_the_published_widths():
    parts = ARCH.detector_flops_parts()
    # ViTDet-H at 1024 px (the windowed blocks' projections on the 70 x 70
    # padded grid), the pyramid, the RPN over p2-p6, three box heads on
    # 1000 RoIs, ViTPose-H on a crop and its mirror
    assert 5.9e12 < parts["backbone"] < 6.0e12
    assert 0.19e12 < parts["pyramid"] < 0.21e12 and 0.2e12 < parts["rpn"] < 0.21e12
    assert 0.76e12 < parts["cascade"] < 0.78e12 and 0.49e12 < parts["pose"] < 0.51e12
    assert ARCH.detector_flops() == sum(parts.values())
    assert ARCH.flops_per_frame({"input_size": 1024}) == \
        ARCH.detector_flops() + manifest.load_arch("hamer").regressor_flops()
    attn = ARCH.attention_work()
    assert len(attn) == 28 + 4 + 32 + 32
    assert attn[0] == {"flops": 4.0 * 25 * 16 * 196 ** 2 * 80,
                       "bytes": 4.0 * (4 * 25 * 16 * 196 * 80 + 25 * 16 * 196 ** 2)}
    assert attn[28]["bytes"] == 4.0 * (4 * 16 * 4096 * 80 + 16 * 4096 ** 2)
    assert ARCH.nms_work() == [{"bytes": 5 * 1000 * 18.0, "flops": 14.0 * 5 * 1000 * 999 / 2},
                               {"bytes": 80 * 1000 * 18.0, "flops": 14.0 * 80 * 1000 * 999 / 2}]
    assert ARCH.roi_align_work() == [{"bytes": 4.0 * 1000 * 256 * 49,
                                      "flops": 10.0 * 1000 * 256 * 49}] * 3


class Obs:
    precision = "fp32"
    peaks = {"fp32": 66.9e12, "bytes_s": 3.35e12}
    batch = 1
    trace = {"annotations": {"port_bench.issue": {"count": 4, "device_s": 0.1},
                             "port_bench.forward": {"count": 4, "device_s": 0.8}},
             "kernels": {"fmha_cutlassF_f32_aligned_64x128_rf_sm80(...)": {
                 "count": 384, "seconds": 0.08},
                 "fmha_cutlassF_f32_aligned_64x64_rf_sm80(...)": {"count": 48, "seconds": 1.0},
                 "acr_nms_kernel": {"count": 8, "seconds": 0.002},
                 "acr_roi_align_kernel": {"count": 12, "seconds": 0.008},
                 "sgemm": {"count": 1, "seconds": 1.0}}}


def test_detector_metrics_read_the_trace():
    read = manifest.load_reader
    peaks = Obs.peaks
    assert read("forward_device_ms.webcam")(Obs()) == pytest.approx(200.0)
    assert read("detect_mfu_pct.webcam")(Obs()) == pytest.approx(
        100 * ARCH.detector_flops() / 0.2 / 66.9e12)
    assert read("detect_attention_roofline_pct.webcam")(Obs()) == pytest.approx(
        100 * ARCH.bound_s(ARCH.attention_work(), peaks) / 0.02)
    assert read("nms_roofline_pct.webcam")(Obs()) == pytest.approx(
        100 * ARCH.bound_s(ARCH.nms_work(), peaks) / 0.0005)
    assert read("roi_align_roofline_pct.webcam")(Obs()) == pytest.approx(
        100 * ARCH.bound_s(ARCH.roi_align_work(), peaks) / 0.002)
    empty = Obs()
    empty.trace = None
    for name in ("forward_device_ms.webcam", "detect_mfu_pct.webcam",
                 "detect_attention_roofline_pct.webcam", "nms_roofline_pct.webcam",
                 "roi_align_roofline_pct.webcam"):
        assert read(name)(empty) is None
    # a trace of the parent, which has no detector stage: nothing to read
    parent = Obs()
    parent.trace = {"annotations": {}, "kernels": {"sgemm": {"count": 1, "seconds": 1.0}}}
    for name in ("nms_roofline_pct.webcam", "roi_align_roofline_pct.webcam",
                 "detect_attention_roofline_pct.webcam", "detect_mfu_pct.webcam"):
        assert read(name)(parent) is None
