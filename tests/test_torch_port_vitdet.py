"""HaMeR's published detector chain on the port (``models/vitdet.py``,
``models/vitpose.py``, ``ops/detect.py``, ``pipeline/vitdet.py`` and the
app with ``detector='vitdet'``) against the benchmark's plain references
``port_bench/reference/vitdet.py`` and ``vitpose.py``. This file imports
nothing of the JAX package.

On the CPU at a small width (``DET``: 32 wide, 4 blocks of which 1 and 3
global, 2 heads, a 160 px input whose 10 x 10 grid pads to windows of
4; ``POSE``: 32 wide, 2 blocks, 128 x 96 crops), on the benchmark's
seeded weights (``archs/hamer_vitdet.py``): the windowed and global
blocks with their relative positions, the pyramid, the RPN, ROIAlignV2
at adaptive sampling, NMS, the cascade and the detections; ViTPose's
flip test, ``post_dark_udp`` and the UDP transform; the masked hand
boxes; the fixed-shape stage against the unpadded reference; and the
whole ``ACRApp.stream_step`` against the reference's sequence. On a card
(marked ``cuda``) the two kernels equal their plain versions bit for bit
and the detect stage replays its graph.

Tolerances, each with its reason:
- ``NET_ATOL`` 2e-5: the port's fused LayerNorm, GELU and
  ``scaled_dot_product_attention`` with its bias against the
  reference's written-out float32 sums, through 4 blocks;
- ``BOX_ATOL`` 2e-3 px: boxes of about 100 px decoded through exp() in
  float32 from logits that differ by ``NET_ATOL``;
- ``KP_ATOL`` 1e-3 px: the port's float32 DARK step against the
  reference's float64, on Gaussian peaks;
- ``HEAT_ATOL`` 1e-5: heatmaps through the small ViT and the head.
"""

import numpy as np
import pytest
import torch

from acr_tpu_torch.config import Config, parse_args
from acr_tpu_torch.models import hamer as hm
from acr_tpu_torch.models import vitdet as vd
from acr_tpu_torch.models import vitpose as vp
from acr_tpu_torch.ops import detect
from acr_tpu_torch.pipeline import graphs
from acr_tpu_torch.pipeline import hamer as ph
from acr_tpu_torch.pipeline import vitdet as pv
from acr_tpu_torch.pipeline.app import ACRApp
from acr_tpu_torch.pipeline.preprocess import resized_shape, vitdet_preprocess
from port_bench.harness import manifest
from port_bench.reference import hamer as rh
from port_bench.reference import vitdet as rv
from port_bench.reference import vitpose as rp

torch.set_num_threads(2)
SIZE = 160
DET = dict(width=32, depth=4, heads=2, mlp=64, window=4, global_blocks=(1, 3),
           fpn=16, pre_nms=60, post_nms=50, fc=32, head_convs=2)
POSE = dict(crop=128, crop_w=96, width=32, depth=2, heads=2, mlp=64)
HAMER = dict(crop=64, crop_w=48, width=64, depth=2, heads=4, mlp=256,
             dec_width=32, dec_depth=1, dec_heads=2, dec_head_dim=16, dec_mlp=32)
NET_ATOL, BOX_ATOL, KP_ATOL, HEAT_ATOL = 2e-5, 2e-3, 1e-3, 1e-5


@pytest.fixture
def small(monkeypatch):
    """The program and the references at the small widths; the arch
    module's weights at those widths."""
    monkeypatch.setattr(vd, "DIMS", vd.Dims(**DET))
    monkeypatch.setattr(rv, "DIMS", rv.Dims(**DET))
    monkeypatch.setattr(vp, "DIMS", vp.Dims(vit=hm.Dims(**POSE), deconv=16))
    monkeypatch.setattr(rp, "DIMS", rp.Dims(vit=rh.Dims(**POSE), deconv=16))
    monkeypatch.setattr(hm, "DIMS", hm.Dims(**HAMER))
    monkeypatch.setattr(rh, "DIMS", rh.Dims(**HAMER))
    return manifest.load_arch("hamer_vitdet")


def weights(arch, seed=2 ** 31 + 7):
    return arch.make_weights(seed, "cpu", torch.float32, {"input_size": SIZE})


def part(w, prefix):
    return {k[len(prefix):]: v for k, v in w.items() if k.startswith(prefix)}


def detector(w):
    with torch.device("meta"):
        net = vd.ViTDet(vd.DIMS, SIZE)
    net.load_state_dict(part(w, "vitdet."), strict=True, assign=True)
    return net.eval()


def frames(n, seed=5, shape=(100, 128)):
    from port_bench.harness.frames import smooth_frames
    return smooth_frames(seed, n, *shape)


def test_windowed_global_blocks_and_relative_positions(small):
    """The backbone over a 10 x 10 grid (windows of 4 padded to 12) with
    two global blocks equals the reference; the relative-position bias
    is ``q . R[i - k + S - 1]`` along each axis."""
    w = weights(small)
    net = detector(w)
    assert [b.window for b in net.backbone.net.blocks] == [4, 0, 4, 0]
    assert net.backbone.net.blocks[1].attn.rel_pos == SIZE // 16
    x = torch.randn(1, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = net.backbone.net(x)
        want = rv.backbone(part(w, "vitdet."), x, rv.DIMS)
    assert got.shape == (1, 32, 10, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=NET_ATOL)
    q = torch.randn(1, 2, 9, 5, dtype=torch.float64)
    rh_, rw_ = torch.randn(5, 5, dtype=torch.float64), torch.randn(5, 5, dtype=torch.float64)
    bias = hm.rel_pos_bias(q, rh_, rw_, 3)
    for a in range(9):
        for b in range(9):
            (i, j), (k, l) = divmod(a, 3), divmod(b, 3)
            np.testing.assert_allclose(
                bias[0, 1, a, b], q[0, 1, a] @ rh_[i - k + 2] + q[0, 1, a] @ rw_[j - l + 2],
                rtol=1e-12)


def test_pyramid_rpn_and_fixed_shape_proposals(small):
    """p2-p6 equal the reference's; the fixed-shape proposals, their
    valid part, are the reference's proposals in the same order."""
    w = weights(small)
    net = detector(w)
    x = torch.randn(1, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(1))
    hw = (125, SIZE)
    with torch.no_grad():
        feats = net.backbone(x)
        want = rv.pyramid(part(w, "vitdet."), rv.backbone(part(w, "vitdet."), x, rv.DIMS))
        rois, valid = net.proposals(feats, hw)
        ref, _ = rv.rpn(part(w, "vitdet."), want, rv.DIMS, hw)
    assert [tuple(f.shape[-2:]) for f in feats] == [(40, 40), (20, 20), (10, 10), (5, 5), (3, 3)]
    for a, b in zip(feats, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=NET_ATOL)
    assert rois.shape == (DET["post_nms"], 4) and int(valid.sum()) == len(ref)
    assert not valid[len(ref):].any() and not rois[~valid].any()
    np.testing.assert_allclose(rois[valid], ref, rtol=0, atol=BOX_ATOL)


def test_roi_align_at_adaptive_sampling_and_levels():
    """ROIAlignV2's plain version against the reference's sampling: boxes
    of every level, grids of 1 to 5 samples a bin, boxes across the edge
    and an empty one."""
    g = torch.Generator().manual_seed(2)
    feats = [torch.randn(3, 64 >> lv, 64 >> lv, generator=g) for lv in range(4)]
    rois = torch.tensor([[3.0, 4.0, 30.0, 21.0], [10.0, 10.0, 120.0, 127.0],
                         [-20.0, -5.0, 40.0, 60.0], [200.0, 150.0, 256.0, 256.0],
                         [0.0, 0.0, 256.0, 256.0], [50.0, 50.0, 50.0, 50.0],
                         [100.0, 30.0, 103.5, 200.0], [-100.0, -100.0, 400.0, 420.0]])
    lv = detect.assign_levels(rois)
    assert sorted(set(lv.tolist())) == [0, 1, 2, 3]
    got = detect.roi_align(feats, rois, lv, 7, 0.25)
    want = rv.roi_align([f[None] for f in feats], rois, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[5].any()


def test_nms_is_greedy_per_segment():
    g = torch.Generator().manual_seed(3)
    xy = torch.rand(4, 40, 2, generator=g) * 50
    boxes = torch.cat([xy, xy + torch.rand(4, 40, 2, generator=g) * 30 + 1], -1)
    valid = torch.rand(4, 40, generator=g) > 0.25
    keep = detect.nms(boxes, valid, 0.5)
    for s in range(4):
        idx = torch.nonzero(valid[s])[:, 0]
        want = idx[rv.nms(boxes[s, idx], 0.5)].tolist()
        assert torch.nonzero(keep[s])[:, 0].tolist() == want


def test_cascade_and_detections_match_reference(small):
    """Three stages and the per-class NMS on the scene's heads: one
    person, the whole image, in the program and the reference alike."""
    w = weights(small)
    net = detector(w)
    rgb = torch.as_tensor(np.ascontiguousarray(frames(1)[0][:, :, ::-1]))
    with torch.no_grad():
        ref = rv.detect(part(w, "vitdet."), rgb, SIZE, rv.DIMS)
        img = pv.resize_input(rgb[None], SIZE)
        got = net(pv.normalise_pad(img, SIZE), tuple(img.shape[2:]))
    dets = [(s, c, r) for s, c, r in ref["detections"]]
    assert int(got["valid"].sum()) == len(dets) >= 1
    np.testing.assert_allclose(got["scores"][:len(dets)], [s for s, _, _ in dets],
                               rtol=0, atol=NET_ATOL)
    assert got["classes"][:len(dets)].tolist() == [c for _, c, _ in dets]
    np.testing.assert_allclose(got["boxes"][:len(dets)],
                               ref["boxes"][[r for _, _, r in dets]], rtol=0, atol=BOX_ATOL)
    persons = [d for d in dets if d[1] == 0 and d[0] > 0.5]
    assert len(persons) == 1
    np.testing.assert_allclose(got["boxes"][0], [0, 0, SIZE, 125], atol=BOX_ATOL)


def _peaks(k, h, w, seed):
    """Heatmaps of Gaussian peaks (sigma 2) at sub-pixel positions, one of
    them against the edge, plus a weak second peak."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    out = np.zeros((k, h, w), np.float32)
    for j in range(k):
        cy, cx = rng.uniform(1, h - 2), rng.uniform(1, w - 2)
        if j == 0:
            cx = 0.3
        out[j] = 0.9 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
        out[j] += 0.3 * np.exp(-((yy - rng.uniform(h)) ** 2 + (xx - rng.uniform(w)) ** 2) / 8.0)
    return out


def test_vitpose_flip_dark_and_udp_match_reference(small):
    """The flip test's heatmaps equal the reference's; the decode
    (argmax, post_dark_udp, UDP transform) equals mmpose's rule as the
    reference writes it; the UDP crop's sampling equals the reference's."""
    w = weights(small)
    with torch.device("meta"):
        net = vp.ViTPose(vp.DIMS)
    net.load_state_dict(part(w, "vitpose."), strict=True, assign=True)
    net.flip_perm = vp.flip_order()
    assert sorted(net.flip_perm.tolist()) == list(range(133))
    assert net.flip_perm[vp.LEFT_HAND + 4] == vp.RIGHT_HAND + 4
    assert net.flip_perm[23 + 36] == 23 + 45 and net.flip_perm[0] == 0
    crops = torch.randn(2, 3, 128, 96, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = net.eval()(crops)
        want = rp.heatmaps(part(w, "vitpose."), crops, rp.DIMS)
    assert got.shape == (2, 133, 32, 24)
    np.testing.assert_allclose(got, want, rtol=0, atol=HEAT_ATOL)
    heat = _peaks(5, 32, 24, 5)
    box = torch.tensor([[30.0, 20.0, 90.0, 100.0]])
    c, s = vp.center_scale(box, vp.DIMS)
    rc, rs = rp.center_scale(box[0].numpy(), rp.DIMS)
    np.testing.assert_allclose(c[0], rc, rtol=1e-6)
    np.testing.assert_allclose(s[0], rs, rtol=1e-6)
    dec = vp.decode(torch.as_tensor(heat)[None], c, s)
    ref = rp.decode(heat.astype(np.float64), rc, rs)
    np.testing.assert_array_equal(dec["argmax"][0], ref["argmax"])
    np.testing.assert_allclose(dec["confidence"][0], ref["confidence"], rtol=1e-6)
    np.testing.assert_allclose(dec["keypoints"][0], ref["keypoints"], rtol=0, atol=KP_ATOL)
    image = torch.rand(1, 3, 60, 80, generator=torch.Generator().manual_seed(6)) * 255
    ys, xs = vp.warp_positions(c, s, vp.DIMS)
    crop = vp.normalise(ph.lerp(ph.lerp(image, ys / 0.5, 2), xs / 0.5, 3))
    np.testing.assert_allclose(crop[0], rp.crop(image[0], rc, rs, (0.5, 0.5), rp.DIMS),
                               rtol=0, atol=1e-4)


def test_masked_hand_boxes(small):
    """The demo's rule: more than 3 valid keypoints detect a hand, its box
    spans the valid ones; a hand with none boxes all 21."""
    rng = np.random.RandomState(7)
    kp = torch.as_tensor(rng.uniform(10, 150, (1, 133, 2)), dtype=torch.float32)
    conf = torch.as_tensor(rng.uniform(0, 1, (1, 133)), dtype=torch.float32)
    conf[0, 112:133] = 0.1                             # the right hand: none
    kp_h, valid, det = pv.hands(kp, conf, torch.tensor([True]))
    rk, rvalid, rdet = rp.hands(kp[0].numpy(), conf[0].numpy(), True)
    np.testing.assert_array_equal(kp_h[0], rk)
    np.testing.assert_array_equal(valid[0], rvalid)
    assert det[0].tolist() == rdet.tolist() == [True, False]
    boxes = ph.boxes_from_joints(kp_h, hm.DIMS, valid)
    np.testing.assert_allclose(boxes[0], rp.hand_boxes(rk, rvalid, rh.DIMS),
                               rtol=0, atol=1e-4)
    assert not pv.hands(kp, conf, torch.tensor([False]))[1].any()


def test_preprocess_resize_and_offsets():
    """detectron2's ResizeShortestEdge(1024, 1024) shapes; the offsets map
    the square's [-1, 1] to the frame's pixels."""
    assert resized_shape(480, 640, 1024) == rv.resized_shape(480, 640, 1024) == (768, 1024)
    assert resized_shape(720, 1280, 1024) == (576, 1024)
    assert resized_shape(640, 480, 1024) == (1024, 768)
    meta = vitdet_preprocess(frames(1)[0], "a/b.jpg", 1024)
    assert meta["image"].shape == (1, 100, 128, 3) and meta["name"] == "b.jpg"
    np.testing.assert_array_equal(meta["offsets"][0], [128, 128, 0, 0, 0, 0, 0, 0, 28, 0])
    np.testing.assert_array_equal(meta["image"][0], frames(1)[0][:, :, ::-1])


def _app(w, temporal=True):
    cfg = Config(configs_yml="", architecture="hamer", detector="vitdet",
                 input_size=SIZE, demo_mode="webcam", temporal_optimization=temporal,
                 save_visualization_on_img=False, focal_length=20000.0,
                 mano_model_path="model_data/mano")
    return ACRApp(cfg, params=w, device="cpu")


def test_fixed_shape_stage_equals_unpadded_reference(small):
    """The detect stage (fixed shapes, validity masks, at most one person)
    against the reference's unpadded chain on frames of the pool."""
    w = weights(small)
    app = _app(w)
    ref = small.Reference(w, {"input_size": SIZE, "temporal_optimization": False,
                              "smooth_coeff": 4.0}, "model_data/mano", "cpu")
    for f in frames(3, seed=11):
        meta = vitdet_preprocess(f, None, SIZE)
        with torch.no_grad():
            got = app.pipeline(meta["image"], meta["offsets"])
        want = ref._frame(f, None)
        assert int(got["persons"][0]) == want["persons"] == 1
        np.testing.assert_allclose(got["person_box"][0], want["person_box"], atol=BOX_ATOL)
        np.testing.assert_allclose(got["person_score"][0], want["person_score"], atol=NET_ATOL)
        np.testing.assert_array_equal(got["kp_argmax"][0], want["kp_argmax"])
        np.testing.assert_allclose(got["kp_conf"][0], want["kp_conf"], atol=HEAT_ATOL)
        np.testing.assert_array_equal(got["hand_valid"][0], want["hand_valid"])
        assert got["detection_flag"][0].tolist() == want["detected"].tolist() == [True, True]


@pytest.mark.parametrize("temporal", [False, True])
def test_stream_step_matches_reference(small, temporal):
    """The whole ``ACRApp.stream_step`` with ``detector='vitdet'`` judged
    by the benchmark's judge: every number within the configuration's
    limits; the steps run eagerly here."""
    w = weights(small)
    app = _app(w, temporal)
    fields = {"input_size": SIZE, "temporal_optimization": temporal,
              "smooth_coeff": 4.0, "render_size": 128, "focal_length": 20000.0}
    ref = small.Reference(w, fields, "model_data/mano", "cpu")
    seq = frames(3, seed=13)
    before = dict(graphs.COUNTS)
    outs = []
    for f in seq:
        out = app.unpack_stream(app.stream_step(vitdet_preprocess(f, None, SIZE)))
        outs.append({k: v[0] for k, v in out.items() if k in small.KEEP})
    assert "_detect" not in out
    numbers = small.new_numbers()
    small.judge_sequence(ref, seq, outs, [0, 1, 2], {}, numbers, fields)
    limits = manifest.load_config("hamer_vitdet_fp32")["limits"]
    assert set(numbers) == set(limits)
    for k, v in numbers.items():
        assert v <= limits[k], (k, numbers)
    assert graphs.COUNTS["detect.eager.cpu"] - before.get("detect.eager.cpu", 0) == 3


def test_detect_stage_spans_and_counters(small):
    """``issue.detect`` with ``detect.backbone``, ``detect.rpn``,
    ``detect.roi`` and ``detect.pose`` inside on the eager path;
    ``DETECT`` counts the read-back frames."""
    app = _app(weights(small))
    app.timer.recording = True
    before = dict(pv.DETECT)
    for f in frames(2, seed=17):
        app.unpack_stream(app.stream_step(vitdet_preprocess(f, None, SIZE)))
    names = [s[0] for s in app.timer.spans()]
    for n in ("issue.detect", "detect.backbone", "detect.rpn", "detect.roi",
              "detect.pose", "issue.regress", "regress.crop", "issue.smooth"):
        assert n in names, n
    assert "issue.forward" not in names
    got = {k: pv.DETECT[k] - before.get(k, 0) for k in ("persons", "over_cap",
                                                      "hands", "hands_missing")}
    assert got == {"persons": 2, "over_cap": 0, "hands": 4, "hands_missing": 0}


def test_config_and_cli():
    assert parse_args(["--architecture", "hamer", "--detector", "vitdet"]).detector == "vitdet"
    with pytest.raises(ValueError, match="acr|vitdet"):
        Config(configs_yml="", architecture="hamer", detector="yolo")
    with pytest.raises(ValueError, match="architecture='hamer'"):
        Config(configs_yml="", detector="vitdet")
    with pytest.raises(ValueError, match="fp32"):
        Config(configs_yml="", architecture="hamer", detector="vitdet",
               model_precision="bf16")


def test_acr_pipeline_imports_no_detector():
    """ACR's pipeline and the HaMeR stage load nothing of the ViTDet chain."""
    import subprocess
    import sys
    code = ("import sys, acr_tpu_torch.pipeline.app\n"
            "print(sorted(m for m in sys.modules if 'vitdet' in m or 'vitpose' in m))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_nms_kernel_equals_plain():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    for s, n, thresh in ((5, 1000, 0.7), (80, 1000, 0.5), (3, 37, 0.3)):
        xy = torch.rand((s, n, 2), generator=g, device=dev) * 900
        boxes = torch.cat([xy, xy + torch.rand((s, n, 2), generator=g, device=dev) * 200 + 1], -1)
        valid = torch.rand((s, n), generator=g, device=dev) < 0.8
        before = detect.LAUNCHES["nms"]
        assert torch.equal(detect.nms(boxes, valid, thresh),
                           detect.nms_plain(boxes, valid, thresh))
        assert detect.LAUNCHES["nms"] == before + 1


@pytest.mark.cuda
def test_roi_align_kernel_equals_plain():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    feats = [torch.randn((256, 256 >> lv, 256 >> lv), generator=g, device=dev)
             for lv in range(4)]
    xy = torch.rand((1000, 2), generator=g, device=dev) * 1000
    rois = torch.cat([xy, xy + torch.rand((1000, 2), generator=g, device=dev) ** 3 * 1000 + 0.5], -1)
    rois[-2:] = torch.tensor([[0.0, 0.0, 1024.0, 768.0], [0.0, 0.0, 0.0, 0.0]], device=dev)
    lv = detect.assign_levels(rois)
    assert torch.equal(detect.roi_align(feats, rois, lv), detect.roi_align_plain(
        feats, rois, lv, 7, 0.25))


@pytest.mark.cuda
def test_detect_graph_replays_and_equals_eager(small):
    """At batch 1 on a card the detect stage captures once, replays with
    no host wait, and equals its eager step bit for bit."""
    dev = _card()
    w = {k: v.to(dev) for k, v in weights(small).items()}
    cfg = Config(configs_yml="", architecture="hamer", detector="vitdet",
                 input_size=SIZE, mano_model_path="model_data/mano")
    pipe = pv.ViTDetPipeline(cfg, params=w, device=dev)
    meta = vitdet_preprocess(frames(1)[0], None, SIZE)
    eager = pipe(meta["image"], meta["offsets"], why="test")
    graphs.reset_counts()
    for _ in range(3):
        got = pipe(meta["image"], meta["offsets"])
    torch.cuda.synchronize()
    assert graphs.COUNTS["detect.capture"] == 1 and graphs.COUNTS["detect.replay"] == 2
    assert [k for k, v in eager.items() if not torch.equal(got[k], v)] == []
