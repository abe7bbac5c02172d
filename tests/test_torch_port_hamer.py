"""HaMeR on the port (``models/hamer.py``, ``pipeline/hamer.py`` and the
``architecture="hamer"`` app) against the plain reference
``tests/ref_hamer.py``, a copy of ``port_bench/reference/hamer.py``. This
file imports nothing of the JAX package.

On the CPU at a small width (``SMALL``: 64 wide, 2 + 1 blocks, 4 heads,
64 x 48 crops), on seeded random weights: the 6D layout, the ViT and the
decoder, the boxes and crops (both hands, the mirror, the blur, a box at
the frame's edge), ``cam_crop_to_full`` and the tail, and the whole
``ACRApp.stream_step`` with and without ``-t``; the regress stage counts
an eager step there, and on a card (marked ``cuda``) it replays its
graph and equals the eager step bit for bit.

Tolerances, each with its reason:
- ``NET_ATOL`` 1e-5: the port's fused LayerNorm, GELU and
  ``scaled_dot_product_attention`` against the reference's written-out
  float32 sums, through 3 blocks;
- ``CROP_ATOL`` 1e-4 (normalised units, one of which is 58 grey
  levels): the port places the samples in float32 (about 1e-5 px at 128
  px) where the reference places them in float64, on a frame with
  steps of up to 255 levels between pixels;
- ``BOX_ATOL`` 1e-4 px: float32 against float64 at 128 px;
- ``MESH_ATOL`` 1e-5 m and ``PX_ATOL`` 5e-3 px: MANO in float32 against
  float64, and the camera at a 10000 px focal length.
"""

import os

import numpy as np
import pytest
import torch

import ref_hamer as ref
from acr_tpu_torch.config import Config, parse_args
from acr_tpu_torch.io.params import init_params
from acr_tpu_torch.models import hamer as hm
from acr_tpu_torch.ops.rotations import rot6d_to_rotmat as acr_rot6d
from acr_tpu_torch.pipeline import graphs
from acr_tpu_torch.pipeline import hamer as ph
from acr_tpu_torch.pipeline.app import ACRApp
from acr_tpu_torch.pipeline.preprocess import img_preprocess
from acr_tpu_torch.pipeline.temporal import init_two_hand_filter, smooth_two_hands

torch.set_num_threads(2)
HERE = os.path.dirname(__file__)
MANO_DIR = os.path.join(HERE, "..", "model_data", "mano")
SMALL = dict(crop=64, crop_w=48, width=64, depth=2, heads=4, mlp=256,
             dec_width=32, dec_depth=1, dec_heads=2, dec_head_dim=16,
             dec_mlp=32)
D, RD = hm.Dims(**SMALL), ref.Dims(**SMALL)
SIZE = 128
NET_ATOL, CROP_ATOL, BOX_ATOL = 1e-5, 1e-4, 1e-4
MESH_ATOL, PX_ATOL = 1e-5, 5e-3


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(hm, "DIMS", D)


def hamer_weights(seed=3, gain=100.0):
    """``init_params`` with the output layers raised back by ``gain``, so
    that the regressed numbers move with the crop."""
    w = hm.init_params(torch.Generator().manual_seed(seed), D)
    for k in w:
        if k.startswith("mano_head.dec"):
            w[k] = w[k] * gain
    return w


def acr_weights():
    """ACR with both hands plausible and in view (the precision tests'
    scene): fuse convs damped and biased to the camera (3, -+0.3, 0)."""
    p = init_params(torch.Generator().manual_seed(0))
    rot6d = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0]).repeat(16)
    for side, tx in (("l", -0.3), ("r", 0.3)):
        p[f"{side}_fuse_conv.weight"] *= 0.05
        p[f"{side}_fuse_conv.weight"][:3] = 0.0
        p[f"{side}_fuse_conv.bias"][:] = torch.cat([
            torch.tensor([3.0, tx, 0.0]), rot6d, torch.zeros(10)])
        p[f"{side}_prior_head.out.weight"] *= 0.05
    return p


def app_params():
    p = acr_weights()
    p.update({"hamer." + k: v for k, v in hamer_weights().items()})
    return p


def make_app(**kw):
    cfg = dict(configs_yml="", input_size=SIZE, render_size=SIZE,
               mano_model_path=MANO_DIR, centermap_conf_thresh=-1e9,
               architecture="hamer", demo_mode="webcam",
               focal_length=ref.FOCAL / D.crop * SIZE)
    cfg.update(kw)
    return ACRApp(Config(**cfg), device="cpu", params=app_params()
                  if cfg["architecture"] == "hamer" else acr_weights())


def frames(n, seed=5):
    rng = np.random.RandomState(seed)
    return [(rng.rand(96, 128, 3) * 255).astype(np.uint8) for _ in range(n)]


def test_reference_copy_is_the_benchmarks():
    """The program's tests and the benchmark hold the port to one reference."""
    with open(os.path.join(HERE, "ref_hamer.py")) as a, open(os.path.join(
            HERE, "..", "port_bench", "reference", "hamer.py")) as b:
        assert a.read() == b.read()
    assert dict(ref.param_shapes(RD)) == {
        k: tuple(v.shape) for k, v in hamer_weights().items()}


def test_6d_layout_is_hamers_not_acrs():
    x = torch.randn(7, 6, generator=torch.Generator().manual_seed(2))
    np.testing.assert_allclose(hm.rot6d_to_rotmat(x), ref.rot6d_to_rotmat(x),
                               rtol=0, atol=1e-6)
    # HaMeR's identity is two rows (1, 0, 0), (0, 1, 0); ACR reads columns
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
    assert torch.equal(hm.rot6d_to_rotmat(ident), torch.eye(3))
    assert not torch.allclose(acr_rot6d(ident), torch.eye(3))
    assert not torch.allclose(hm.rot6d_to_rotmat(x), acr_rot6d(x), atol=1e-2)


def test_vit_and_decoder_match_reference():
    w = hamer_weights()
    net = hm.HaMeR(D).eval()
    net.load_state_dict(w, strict=True)
    x = torch.randn(4, 3, D.crop, D.crop_w, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        tokens = net.backbone(x)
        want = ref.vit(w, x, RD)
        np.testing.assert_allclose(tokens, want, rtol=0, atol=NET_ATOL)
        got = net(x)
        np.testing.assert_allclose(got, ref.regress(w, x, RD), rtol=0,
                                   atol=NET_ATOL)
    # the regressed numbers depend on the crop
    assert (got[0] - got[1]).abs().max() > 1e-3


def _joints(seed):
    """Both hands' joints in [-1, 1]: the left large enough for the blur,
    the right at the frame's right edge."""
    pj = torch.tensor(np.random.RandomState(seed).rand(1, 2, 21, 2) * 1.2 - 0.6,
                      dtype=torch.float32)
    pj[0, 0] = pj[0, 0] * 1.5
    pj[0, 1] = pj[0, 1] * 0.3 + 0.85
    return pj


def test_boxes_and_crops_match_reference():
    img = torch.as_tensor((np.random.RandomState(0).rand(1, SIZE, SIZE, 3)
                           * 255).astype(np.uint8))
    pj = _joints(1)
    boxes = ph.boxes_from_joints((pj + 1.0) * (SIZE / 2.0), D)
    want = ref.boxes(((pj.double() + 1) * SIZE / 2).numpy(), RD)
    np.testing.assert_allclose(boxes, want, rtol=0, atol=BOX_ATOL)
    factor = boxes[0, :, 2] / D.crop / 2
    assert factor[0] > ph.BLUR_AT > factor[1]          # one blurred, one not
    assert boxes[0, 1, 0] + boxes[0, 1, 2] / 2 > SIZE  # one over the edge
    crops = ph.crops(img, boxes, torch.tensor([[True, True]]), D)
    assert crops.shape == (2, 3, D.crop, D.crop_w)
    for h in range(2):
        np.testing.assert_allclose(
            crops[h], ref.crop(img[0].numpy(), boxes[0, h].numpy(), h == 0, RD),
            rtol=0, atol=CROP_ATOL)
    # the left crop is the unmirrored crop of the mirrored frame about the
    # mirrored centre
    mirrored = boxes.clone()
    mirrored[0, 1] = torch.stack([SIZE - 1 - boxes[0, 0, 0], boxes[0, 0, 1],
                                  boxes[0, 0, 2]])
    flipped = ph.crops(img.flip(2), mirrored, torch.tensor([[True, True]]), D)
    np.testing.assert_allclose(flipped[1], crops[0], rtol=0, atol=CROP_ATOL)
    # an undetected hand's crop is zero
    none = ph.crops(img, boxes, torch.tensor([[False, True]]), D)
    assert not none[0].any() and torch.equal(none[1], crops[1])


def test_cam_crop_to_full_and_tail_match_reference(small):
    g = torch.Generator().manual_seed(4)
    cam = torch.tensor([[[4.0, -0.3, 0.1], [3.5, 0.2, -0.1]]])
    boxes = torch.tensor([[[40.0, 70.0, 90.0], [100.0, 60.0, 70.0]]])
    focal = ref.FOCAL / D.crop * SIZE
    np.testing.assert_allclose(
        ph.cam_crop_to_full(cam, boxes, SIZE, focal),
        ref.cam_crop_to_full(cam.double(), boxes.double(), SIZE, focal),
        rtol=1e-6)
    app = make_app(temporal_optimization=False)
    poses = torch.randn(1, 2, 48, generator=g) * 0.3
    betas = torch.randn(1, 2, 10, generator=g) * 0.5
    offsets = torch.tensor([[128.0, 128, 0, 0, 0, 0, 16, 0, 16, 0]])
    assert app.pipeline.tail == app.regressor.tail
    got = app.pipeline.refine(poses, betas,
                              ph.cam_crop_to_full(cam, boxes, SIZE, focal),
                              offsets)
    m = ref.load_mano(MANO_DIR, "cpu")
    from acr_tpu_torch.ops.rotations import axis_angle_to_rotmat
    rot = axis_angle_to_rotmat(poses.reshape(2, 16, 3)).double()
    verts, j3d = ref.mano_forward(m, rot, betas.reshape(2, 10))
    mirror = torch.tensor([-1.0, 1.0, 1.0], dtype=torch.float64)
    verts = torch.stack([verts[0] * mirror, verts[1]])[None]
    j3d = torch.stack([j3d[0] * mirror, j3d[1]])[None]
    trans = ref.cam_crop_to_full(cam.double(), boxes.double(), SIZE, focal)
    placed = j3d + trans[:, :, None]
    px = focal * placed[..., :2] / placed[..., 2:] + SIZE / 2
    np.testing.assert_allclose(got["verts"], verts, rtol=0, atol=MESH_ATOL)
    np.testing.assert_allclose(got["j3d"], j3d, rtol=0, atol=MESH_ATOL)
    np.testing.assert_allclose(got["cam_trans"], trans, rtol=1e-6)
    np.testing.assert_allclose((got["pj2d"] + 1) * SIZE / 2, px, rtol=0,
                               atol=PX_ATOL)
    # the frame's pixels: 128 px of input over 128 px of padded frame,
    # shifted by the padding's top (16 px)
    np.testing.assert_allclose(got["pj2d_org"][..., 1], px[..., 1] - 16,
                               rtol=0, atol=PX_ATOL)


def _reference_step(app, image, det_pj2d, poses=None, betas=None):
    """The reference's crops, network and tail on the program's own
    detections; ``poses`` and ``betas`` (axis-angle) replace the regressed
    ones where given (the smoothed ones)."""
    w = {k: v for k, v in app.regressor.net.state_dict().items()}
    boxes = ref.boxes(((det_pj2d.double() + 1) * SIZE / 2).numpy(), RD)
    crops = torch.stack([ref.crop(image[0], boxes[0, h], h == 0, RD)
                         for h in range(2)])
    with torch.no_grad():
        params = ref.regress(w, crops, RD)
    if poses is None:
        from acr_tpu_torch.ops.rotations import rotmat_to_axis_angle
        poses = rotmat_to_axis_angle(ref.rot6d_to_rotmat(
            params[:, :96].reshape(2, 16, 6))).reshape(2, 48)
        betas = params[:, 96:106]
    from acr_tpu_torch.ops.rotations import axis_angle_to_rotmat
    verts, j3d = ref.mano_forward(ref.load_mano(MANO_DIR, "cpu"),
                                  axis_angle_to_rotmat(poses.reshape(2, 16, 3)),
                                  betas.reshape(2, 10))
    mirror = torch.tensor([-1.0, 1.0, 1.0], dtype=torch.float64)
    cam = params[:, 96 + 10:].double() * torch.tensor(
        [[1.0, -1.0, 1.0], [1.0, 1.0, 1.0]], dtype=torch.float64)
    trans = ref.cam_crop_to_full(cam, torch.as_tensor(boxes[0]), SIZE,
                                 ref.FOCAL / RD.crop * SIZE)
    return {"hamer_params": params.numpy(), "boxes": boxes[0],
            "verts": torch.stack([verts[0] * mirror, verts[1]]).numpy(),
            "cam_trans": trans.numpy()}


@pytest.mark.parametrize("temporal", [False, True])
def test_stream_step_matches_reference(small, temporal):
    """Three stream steps: the detector's joints box the hands, and the
    app's regressed numbers, meshes and translations are the reference's
    on them; with ``-t`` the meshes are those of OneEuro's poses."""
    app = make_app(temporal_optimization=temporal, save_visualization_on_img=False)
    state = init_two_hand_filter("cpu")
    graphs.reset_counts()
    before = ph.CROPS["crops"]
    for k, frame in enumerate(frames(3)):
        meta = img_preprocess(frame, str(k), input_size=SIZE)
        det = app.pipeline(meta["image"], meta["offsets"])
        out = app.unpack_stream(app.stream_step(meta))
        assert out["detection_flag"].all()
        np.testing.assert_allclose(out["boxes"][0], ref.boxes(
            ((det["pj2d"].double() + 1) * SIZE / 2).numpy(), RD)[0],
            rtol=0, atol=BOX_ATOL)
        want = _reference_step(app, meta["image"], det["pj2d"])
        np.testing.assert_allclose(out["hamer_params"][0], want["hamer_params"],
                                   rtol=0, atol=10 * NET_ATOL)
        if temporal:
            state, poses, betas = smooth_two_hands(
                state, _regressed(app, meta, det), torch.as_tensor(
                    out["hamer_params"][0, :, 96:106]),
                torch.tensor([True, True]), app.cfg.smooth_coeff)
            np.testing.assert_allclose(out["poses"][0], poses, rtol=0, atol=1e-6)
            want = _reference_step(app, meta["image"], det["pj2d"], poses, betas)
        np.testing.assert_allclose(out["verts"][0], want["verts"], rtol=0,
                                   atol=MESH_ATOL)
        np.testing.assert_allclose(out["cam_trans"][0], want["cam_trans"],
                                   rtol=1e-4)
    assert graphs.COUNTS["regress.eager.cpu"] == 3
    assert ph.CROPS["crops"] - before == 6


def _regressed(app, meta, det):
    """The app's regressed poses (axis-angle) of one frame, before OneEuro."""
    res = app.regressor.regress(torch.as_tensor(meta["image"]),
                                (det["pj2d"] + 1.0) * (app.cfg.input_size / 2.0),
                                None, det["detection_flag"])
    return res["poses"][0]


def test_regress_stage_spans_and_chunk_step(small):
    """The regress stage is ``issue.regress`` with ``regress.crop`` and
    ``regress.net`` inside on the eager path; a folder chunk of two frames
    runs it eagerly and equals two single steps."""
    app = make_app(save_visualization_on_img=False, temporal_optimization=False)
    app.timer.recording = True
    metas = [img_preprocess(f, str(k), input_size=SIZE)
             for k, f in enumerate(frames(2, seed=9))]
    singles = [app.unpack_stream(app.stream_step(m)) for m in metas]
    spans = {(name, parent) for name, parent, *_ in app.timer.spans()}
    assert {("issue.regress", None), ("regress.crop", "issue.regress"),
            ("regress.net", "issue.regress")} <= spans
    graphs.reset_counts()
    chunk = app.chunk_step(np.concatenate([m["image"] for m in metas]),
                           np.concatenate([m["offsets"] for m in metas]))
    assert graphs.COUNTS["regress.eager.cpu"] == 1
    for k in range(2):
        for key in ("hamer_params", "verts", "cam_trans", "pj2d_org"):
            np.testing.assert_allclose(chunk[key][k].numpy(), singles[k][key][0],
                                       rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("architecture", ["acr", "hamer"])
def test_chunk_step_equals_single_steps_with_smoothing(small, architecture):
    """With ``-t`` a folder chunk of two frames equals the two frames
    through two single-frame steps, OneEuro's state carried from the first
    to the second; each side from a fresh app. A batch of two need not
    give a batch of one's bits."""
    def fresh():
        return make_app(architecture=architecture, temporal_optimization=True,
                        save_visualization_on_img=False)
    metas = [img_preprocess(f, str(k), input_size=SIZE)
             for k, f in enumerate(frames(2, seed=13))]
    app = fresh()
    singles = [app.unpack_stream(app.stream_step(m)) for m in metas]
    app = fresh()
    graphs.reset_counts()
    chunk = app.chunk_step(np.concatenate([m["image"] for m in metas]),
                           np.concatenate([m["offsets"] for m in metas]))
    assert graphs.COUNTS["smooth.eager.cpu"] == 1
    assert all(o["detection_flag"].all() for o in singles)
    keys = ["poses", "betas", "verts", "j3d", "cam_trans", "pj2d_org"]
    if architecture == "hamer":
        keys.append("hamer_params")
    for k in range(2):
        for key in keys:
            np.testing.assert_allclose(chunk[key][k].numpy(), singles[k][key][0],
                                       rtol=1e-5, atol=1e-5, err_msg=key)


class _Shifted:
    """The app's pipeline with the mesh of its forward and of its refine
    moved by ``SHIFT`` (the benchmark's ``altered`` fault)."""
    SHIFT = 1e-4

    def __init__(self, inner):
        self.inner = inner

    def __call__(self, *a, **k):
        out = self.inner(*a, **k)
        out["verts"] = out["verts"] + self.SHIFT
        return out

    def refine(self, *a, **k):
        out = self.inner.refine(*a, **k)
        out["verts"] = out["verts"] + self.SHIFT
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


@pytest.mark.parametrize("temporal", [False, True])
def test_every_mesh_comes_out_of_the_pipeline(small, temporal):
    """HaMeR's meshes, the regress stage's and OneEuro's, come out of the
    pipeline's ``refine``, looked up at call time, so a wrapper of the
    app's pipeline moves every mesh the step returns."""
    metas = [img_preprocess(f, str(k), input_size=SIZE)
             for k, f in enumerate(frames(2, seed=17))]
    outs = []
    for wrap in (False, True):
        app = make_app(temporal_optimization=temporal,
                       save_visualization_on_img=False)
        if wrap:
            app.pipeline = _Shifted(app.pipeline)
        outs.append([app.unpack_stream(app.stream_step(m)) for m in metas])
    for plain, moved in zip(*outs):
        np.testing.assert_array_equal(moved["hamer_params"],
                                      plain["hamer_params"])
        np.testing.assert_allclose(moved["verts"], plain["verts"] + _Shifted.SHIFT,
                                   rtol=0, atol=1e-6)


def test_detector_pipeline_imports_no_hamer():
    """ACR's pipeline knows no architecture that runs on its detections."""
    import subprocess
    import sys
    code = ("import sys, acr_tpu_torch.pipeline.infer\n"
            "print(sorted(m for m in ('acr_tpu_torch.pipeline.hamer',\n"
            "                         'acr_tpu_torch.models.hamer')\n"
            "             if m in sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=os.path.join(HERE, ".."), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_config_and_cli(small, tmp_path):
    assert parse_args(["--architecture", "hamer"]).architecture == "hamer"
    with pytest.raises(ValueError, match="acr|hamer"):
        Config(configs_yml="", architecture="vit")
    with pytest.raises(ValueError, match="fp32"):
        Config(configs_yml="", architecture="hamer", model_precision="bf16")
    import cv2
    from acr_tpu_torch import cli
    from acr_tpu_torch.io.params import save_params_npz
    save_params_npz(str(tmp_path / "acr.npz"), acr_weights())
    cv2.imwrite(str(tmp_path / "hand.jpg"), frames(1)[0])
    results = cli.main([
        "--architecture", "hamer", "--demo_mode", "image",
        "--inputs", str(tmp_path / "hand.jpg"),
        "--model_path", str(tmp_path / "acr.npz"), "--mano_model_path", MANO_DIR,
        "--configs_yml", "", "--input_size", str(SIZE), "--render_size", str(SIZE),
        "--centermap_conf_thresh=-1e9", "--output_dir", str(tmp_path / "out") + "/",
        "--device", "cpu"])
    assert len(results[str(tmp_path / "hand.jpg")]) == 2
    assert os.path.exists(tmp_path / "out" / "hand.jpg")


@pytest.mark.cuda
def test_regress_graph_replays_and_equals_eager(small):
    """On a card the regress stage captures once and replays, with no host
    wait, and its outputs equal the eager stage's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = Config(configs_yml="", input_size=SIZE, render_size=SIZE,
                 mano_model_path=MANO_DIR, centermap_conf_thresh=-1e9,
                 architecture="hamer", demo_mode="webcam",
                 temporal_optimization=True, save_visualization_on_img=False)
    metas = [img_preprocess(f, str(k), input_size=SIZE)
             for k, f in enumerate(frames(6, seed=11))]
    outs = {}
    for mode in ("graph", "eager"):
        app = ACRApp(cfg, params=app_params(), device="cuda")
        if mode == "eager":
            app.pipeline.graph_block = lambda batch: "batch"
        graphs.reset_counts()
        got = []
        for k, m in enumerate(metas):
            if mode == "graph" and k >= 3:
                torch.cuda.set_sync_debug_mode("error")
            try:
                got.append(app.stream_step(m))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            got[-1] = app.unpack_stream(got[-1])
        outs[mode] = (got, dict(graphs.COUNTS))
    (graph, counts), (eager, eager_counts) = outs["graph"], outs["eager"]
    assert counts["regress.capture"] == 1 and counts["regress.replay"] == 5
    assert eager_counts["regress.eager.batch"] == 6
    for a, b in zip(graph, eager):
        for key in ("hamer_params", "boxes", "verts", "cam_trans", "pj2d_org"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
