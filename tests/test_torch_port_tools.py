"""The port's run-level tools against the JAX package: the profiler trace
(``utils.profiling``), the config session (``utils.session``), the CLI
that wraps a run in both, and the ground-truth centre maps
(``parser.centermap_gt``, to 1e-6 against JAX's).

The CLI runs image mode on the CPU at 64 px on the flax weights of
``tests/test_torch_port_app.py``, saved as a flax-path npz.
"""

import dataclasses
import glob
import inspect
import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from acr_tpu.parser import centermap_gt as jgt
from acr_tpu.utils import session as jsession
from acr_tpu_torch.config import Config
from acr_tpu_torch.parser import centermap_gt as tgt
from acr_tpu_torch.utils import session as tsession
from acr_tpu_torch.utils.profiling import profile_trace
from test_torch_port_app import MANO_DIR, flat  # noqa: F401 (fixture)

torch.set_num_threads(2)


def test_profile_trace_none_is_noop(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for unset in (None, ""):
        with profile_trace(unset, "cpu"):
            torch.ones(4).sum()
    assert os.listdir(tmp_path) == []


def test_profile_trace_writes_a_trace(tmp_path):
    d = tmp_path / "trace"
    with profile_trace(str(d), "cpu"):
        torch.nn.functional.conv2d(torch.ones(1, 3, 8, 8), torch.ones(4, 3, 3, 3))
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(d / files[0]) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::conv2d" in names


def test_config_session_copy_equal():
    assert inspect.getsource(tsession.ConfigSession) == \
        inspect.getsource(jsession.ConfigSession)


def test_config_session_writes_and_removes(tmp_path):
    cfg = Config(tab="port/test", configs_yml="")
    session = tsession.ConfigSession(cfg, out_dir=str(tmp_path / "active"))
    assert os.path.basename(session.path).startswith("port_test_")
    with session as got:
        assert got is cfg
        with open(session.path) as f:
            dumped = yaml.safe_load(f)
        assert dumped["tab"] == "port/test"
        assert dumped == yaml.safe_load(yaml.safe_dump(dataclasses.asdict(cfg)))
    assert not os.path.exists(session.path)


def test_cli_image_mode_with_profile_dir(flat, tmp_path, monkeypatch):
    """``cli.main`` in image mode on the CPU: the merged config sits in
    ``active_configs/`` while the run lasts and is gone after it, and
    ``--profile_dir`` leaves one trace of the run."""
    import cv2
    from acr_tpu_torch import cli
    from acr_tpu_torch.pipeline import app as app_mod
    monkeypatch.chdir(tmp_path)
    np.savez(tmp_path / "weights.npz", **flat)
    rng = np.random.RandomState(4)
    cv2.imwrite(str(tmp_path / "hand.jpg"),
                (rng.rand(48, 64, 3) * 255).astype(np.uint8))
    seen = []
    run = app_mod.ACRApp.run

    def watched(self):
        seen.extend(glob.glob(str(tmp_path / "active_configs" / "*.yaml")))
        return run(self)

    monkeypatch.setattr(app_mod.ACRApp, "run", watched)
    results = cli.main([
        "--demo_mode", "image", "--inputs", str(tmp_path / "hand.jpg"),
        "--model_path", str(tmp_path / "weights.npz"),
        "--mano_model_path", MANO_DIR, "--configs_yml", "",
        "--input_size", "64", "--render_size", "64",
        "--centermap_conf_thresh=-1e9",
        "--output_dir", str(tmp_path / "out") + "/",
        "--profile_dir", str(tmp_path / "prof"), "--device", "cpu"])
    assert len(results[str(tmp_path / "hand.jpg")]) == 2
    assert os.listdir(tmp_path / "out") == ["hand.jpg"]
    assert len(seen) == 1 and os.path.basename(seen[0]).startswith("ACR_")
    assert os.listdir(tmp_path / "active_configs") == []
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")


@pytest.mark.parametrize("k,sigma", [(5, 1.0), (4, 1.0), (7, 2.0)])
def test_gaussian_kernel_equal(k, sigma):
    np.testing.assert_array_equal(tgt.gaussian_kernel(k, sigma),
                                  jgt.gaussian_kernel(k, sigma))


@pytest.mark.parametrize("size,sigma", [(64, 1.0), (16, 2.5)])
def test_render_center_maps_matches_jax(size, sigma):
    rng = np.random.RandomState(size)
    centers = (rng.rand(3, 4, 2) * size).astype(np.float32)
    valid = rng.rand(3, 4) > 0.3
    valid[0] = False                         # an empty map
    got = tgt.render_center_maps(torch.from_numpy(centers),
                                 torch.from_numpy(valid), size, sigma)
    want = jgt.render_center_maps(jnp.asarray(centers), jnp.asarray(valid),
                                  size, sigma)
    assert tuple(got.shape) == (3, size, size, 1)
    assert not got[0].any() and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
