"""The port's host-side copies equal the originals, every option value
the port runs validates in ``Config``, and neither an acr_tpu_torch module nor chip_smoke.py
imports JAX, the JAX package, orbax or tensorstore."""

import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from acr_tpu import config as jconfig
from acr_tpu.io import writers as jwriters
from acr_tpu.pipeline import capture as jcapture
from acr_tpu.pipeline import preprocess as jpre
from acr_tpu.pipeline import results as jres
from acr_tpu.utils import meters as jmeters
from acr_tpu_torch import config as tconfig
from acr_tpu_torch.io import writers as twriters
from acr_tpu_torch.pipeline import capture as tcapture
from acr_tpu_torch.pipeline import preprocess as tpre
from acr_tpu_torch.pipeline import results as tres
from acr_tpu_torch.utils import meters as tmeters

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shared(fields):
    """A Config's fields without the port's own (``config.PORT_ONLY``)."""
    assert tconfig.PORT_ONLY == ("architecture", "detector")
    return {k: v for k, v in fields.items() if k not in tconfig.PORT_ONLY}


def test_config_fields_and_defaults_equal():
    jf = [(f.name, str(f.type)) for f in dataclasses.fields(jconfig.Config)]
    tf = [(f.name, str(f.type)) for f in dataclasses.fields(tconfig.Config)
          if f.name not in tconfig.PORT_ONLY]
    assert tf == jf
    assert _shared(dataclasses.asdict(tconfig.Config())) == \
        dataclasses.asdict(jconfig.Config())
    assert tconfig.Config().architecture == "acr"
    assert tconfig.Config().detector == "acr"


@pytest.mark.parametrize("argv", [
    [],
    ["--demo_mode", "image", "--inputs", "x.jpg", "-s", "-v",
     "--render_size", "256", "--show_items", "mesh", "pj2d",
     "--inter_prior", "false", "--prior_mode", "none", "--not_a_flag", "1"],
    ["--configs_yml", os.path.join(REPO, "configs", "demo.yml"),
     "--FOV", "30"],
])
def test_parse_args_equal(argv):
    assert _shared(dataclasses.asdict(tconfig.parse_args(argv))) == \
        dataclasses.asdict(jconfig.parse_args(argv))


@pytest.mark.parametrize("shape", [(96, 128, 3), (130, 70, 3), (64, 64, 3),
                                   (128, 128, 3)])
def test_preprocess_copy_equal(shape):
    rng = np.random.RandomState(sum(shape))
    frame = (rng.rand(*shape) * 255).astype(np.uint8)
    assert tpre.compute_pad_trbl(shape) == jpre.compute_pad_trbl(shape)
    for a, b in zip(tpre.pad_white_square(frame), jpre.pad_white_square(frame)):
        np.testing.assert_array_equal(a, b)
    got = tpre.img_preprocess(frame, "a/b.jpg", input_size=128)
    want = jpre.img_preprocess(frame, "a/b.jpg", input_size=128)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_results_copy_equal():
    rng = np.random.RandomState(0)
    out = {k: rng.randn(2, 2, *s).astype(np.float32) for k, s in (
        ("cam", (3,)), ("cam_trans", (3,)), ("poses", (48,)),
        ("betas", (10,)), ("j3d", (21, 3)), ("verts", (778, 3)),
        ("pj2d", (21, 2)), ("pj2d_org", (21, 2)))}
    out["detection_flag"] = np.array([[True, False], [True, True]])
    got = tres.reorganize_results(out, ["a", "b"])
    want = jres.reorganize_results(out, ["a", "b"])
    assert got.keys() == want.keys()
    for path in want:
        assert len(got[path]) == len(want[path])
        for g, w in zip(got[path], want[path]):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    assert tres.sort_results_by_hand(got).keys() == \
        jres.sort_results_by_hand(want).keys()


def test_writers_copy_equal(tmp_path):
    for name in ("collect_image_list", "split_frame", "_frame_sort_key",
                 "save_video", "save_results", "IMG_EXTS", "_AUX_SUFFIXES"):
        j, t = getattr(jwriters, name), getattr(twriters, name)
        if callable(j):
            assert inspect.getsource(t) == inspect.getsource(j), name
        else:
            assert t == j, name
    for rel in ("b/10.jpg", "b/2.png", "a/1.JPG", "c.txt"):
        (tmp_path / rel).parent.mkdir(exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    assert twriters.collect_image_list(str(tmp_path)) == \
        jwriters.collect_image_list(str(tmp_path))


@pytest.mark.parametrize("module_pair,names", [
    ((jmeters, tmeters), ("AverageMeter", "AverageMeterDict", "StageTimer")),
    ((jcapture, tcapture), ("OpenCVCapture", "WebcamVideoStream")),
])
def test_meters_and_capture_copies_equal(module_pair, names):
    j, t = module_pair
    for name in names:
        assert inspect.getsource(getattr(t, name)) == \
            inspect.getsource(getattr(j, name)), name


def validates(**override):
    """``Config(**override)`` constructs, its validation passing, and
    holds every value it was given."""
    cfg = tconfig.Config(**override)
    for name, value in override.items():
        assert getattr(cfg, name) == value, name


@pytest.mark.parametrize("override", [
    dict(data_parallel=2),
    dict(renderer="native"),
    dict(jit_translation_solve=False),
    dict(profile_dir="trace"),
    dict(demo_mode="folder", val_batch_size=2, data_parallel=4,
         model_precision="bf16", renderer="native",
         jit_translation_solve=False, profile_dir="trace"),
])
def test_last_options_accepted(override):
    # data parallelism (A14), the native renderer, the host solve and the
    # profiler trace (A15) run now, alone and together; so do the TPU
    # rewrites, the default slice and the streaming slice
    validates(**override)
    validates(s2d_highres=False, merged_heads=False)
    for mode in ("image", "folder", "video", "webcam"):
        validates(demo_mode=mode, temporal_optimization=True,
                  render_size=2048, interactive_vis=True)


@pytest.mark.parametrize("override", [
    dict(use_pallas_mano="on"),
    dict(demo_mode="video", val_batch_size=4, temporal_optimization=True),
    dict(demo_mode="folder", val_batch_size=2),
])
def test_throughput_options_accepted(override):
    # the throughput slice: the fused MANO kernel and video/folder mode
    # at val_batch_size > 1 (ROADMAP A12, A9b) run now
    validates(**override)


@pytest.mark.parametrize("override", [
    dict(model_precision="bf16"),
    dict(quantize="int8"),
    dict(quantize="int8_pc", model_precision="bf16"),
    dict(quantize="int8_r"),
    dict(quantize="int4w", model_precision="bf16"),
    dict(show_items=("mesh", "org_img", "pj2d", "centermap", "j3d")),
    dict(demo_mode="folder", val_batch_size=2, model_precision="bf16",
         quantize="int8", show_items=("mesh", "centermap")),
    dict(demo_mode="webcam", temporal_optimization=True,
         model_precision="bf16", quantize="int8"),
])
def test_precision_and_aux_options_accepted(override):
    # bf16 (A6), the four int8 modes (A13) and the aux views (A10) run now
    validates(**override)


def test_cli_data_parallel_over_one_card_raises_before_loading(monkeypatch,
                                                              tmp_path):
    # one visible card cannot hold two replicas by default: make_mesh
    # raises JAX's ValueError before any weight is read
    from acr_tpu_torch.cli import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("ACR_COORDINATOR", raising=False)
    monkeypatch.chdir(tmp_path)             # the config session's directory
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        main(["--demo_mode", "video", "--val_batch_size", "2",
              "--data_parallel", "2", "--configs_yml", "",
              "--model_path", "/nonexistent.npz"])


def test_no_module_imports_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import acr_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    acr_tpu_torch.__path__, 'acr_tpu_torch.')]\n"
        "for n in names + ['chip_smoke']:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and (m in ('acr_tpu', 'tools', 'bench', '__graft_entry__')\n"
        "                  or m.startswith(\n"
        "                 ('acr_tpu.', 'tools.', 'jax', 'flax', 'orbax',\n"
        "                  'tensorstore'))))\n"
        "assert not bad, bad\n"
        "new = {'acr_tpu_torch.pipeline.' + m for m in\n"
        "       ('temporal', 'streaming', 'capture')}\n"
        "new |= {'acr_tpu_torch.utils.meters', 'acr_tpu_torch.utils.device',\n"
        "        'acr_tpu_torch.ops.mano_kernel', 'acr_tpu_torch.ops.cuda_lib',\n"
        "        'acr_tpu_torch.ops.quant', 'acr_tpu_torch.viz.skeleton3d',\n"
        "        'acr_tpu_torch.parallel', 'acr_tpu_torch.parallel.mesh',\n"
        "        'acr_tpu_torch.io.native', 'acr_tpu_torch.utils.profiling',\n"
        "        'acr_tpu_torch.utils.session',\n"
        "        'acr_tpu_torch.parser.centermap_gt',\n"
        "        'acr_tpu_torch.io.torch_names', 'acr_tpu_torch.tools',\n"
        "        'acr_tpu_torch.io.orbax', 'acr_tpu_torch.bench'}\n"
        "new |= {'acr_tpu_torch.tools.' + m for m in\n"
        "        ('convert_checkpoint', 'convert_mano', 'make_synthetic_mano',\n"
        "         'make_synthetic_checkpoint', 'make_calib_frames',\n"
        "         'ingest_real_assets', 'quant_accuracy', 'profile_step',\n"
        "         'dryrun', 'stream_setup', 'stream_bench', 'profile_stream',\n"
        "         'precision_ladder')}\n"
        "assert new <= set(names), names\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 58
