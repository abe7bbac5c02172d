"""The port's host-side copies equal the originals, its unported options
raise, and neither an acr_tpu_torch module nor chip_smoke.py imports JAX
or the JAX package."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from acr_tpu import config as jconfig
from acr_tpu.pipeline import preprocess as jpre
from acr_tpu.pipeline import results as jres
from acr_tpu_torch import config as tconfig
from acr_tpu_torch.pipeline import preprocess as tpre
from acr_tpu_torch.pipeline import results as tres
from acr_tpu_torch.pipeline.infer import check_slice

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_config_fields_and_defaults_equal():
    jf = [(f.name, str(f.type)) for f in dataclasses.fields(jconfig.Config)]
    tf = [(f.name, str(f.type)) for f in dataclasses.fields(tconfig.Config)]
    assert tf == jf
    assert dataclasses.asdict(tconfig.Config()) == \
        dataclasses.asdict(jconfig.Config())


@pytest.mark.parametrize("argv", [
    [],
    ["--demo_mode", "image", "--inputs", "x.jpg", "-s", "-v",
     "--render_size", "256", "--show_items", "mesh", "pj2d",
     "--inter_prior", "false", "--prior_mode", "none", "--not_a_flag", "1"],
    ["--configs_yml", os.path.join(REPO, "configs", "demo.yml"),
     "--FOV", "30"],
])
def test_parse_args_equal(argv):
    assert dataclasses.asdict(tconfig.parse_args(argv)) == \
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


@pytest.mark.parametrize("override,item", [
    (dict(temporal_optimization=True), "A8"),
    (dict(model_precision="bf16"), "A6"),
    (dict(quantize="int8"), "A13"),
    (dict(data_parallel=2), "A14"),
    (dict(renderer="native"), "A15"),
    (dict(use_pallas_mano="on"), "A12"),
    (dict(demo_mode="video"), "A9"),
    (dict(render_size=2048), "A11"),
    (dict(show_items=("mesh", "pj2d")), "A10"),
])
def test_unported_options_raise(override, item):
    with pytest.raises(NotImplementedError, match=item):
        check_slice(tconfig.Config(**override))
    # the TPU rewrites and the default slice are accepted
    check_slice(tconfig.Config(s2d_highres=False, merged_heads=False))


def test_cli_rejects_unported_mode_before_loading():
    from acr_tpu_torch.cli import main
    with pytest.raises(NotImplementedError, match="A9"):
        main(["--demo_mode", "webcam", "--model_path", "/nonexistent.npz",
              "--device", "cpu"])


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
        "             and (m == 'acr_tpu' or m.startswith(('acr_tpu.', 'jax', 'flax'))))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20
