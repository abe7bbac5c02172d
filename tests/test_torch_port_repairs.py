"""The two repairs of the streaming slice.

* ``Visualizer.paste_back`` above 1000 px of render scales the frame and
  all ten offsets by 4 before the paste (acr_tpu/viz/visualizer.py:
  148-152); port and JAX must give the same pixels.
* The CLI's ``--device`` is ``cuda`` unless ``--device cpu`` is given,
  and without a card it raises instead of falling back to the CPU.

And the repairs of the throughput slice and after: ``ACRApp``,
``ACRPipeline``, ``Visualizer``, ``load_mano_model`` and the OneEuro
state's ``init_*`` default to the card in the same way.
"""

import os

import numpy as np
import pytest
import torch

from acr_tpu.config import Config as JaxConfig
from acr_tpu.viz.visualizer import Visualizer as JaxVisualizer
from acr_tpu_torch.config import Config
from acr_tpu_torch.pipeline.preprocess import img_preprocess
from acr_tpu_torch.viz.visualizer import Visualizer

torch.set_num_threads(2)
MANO_DIR = os.path.join(os.path.dirname(__file__), "..", "model_data", "mano")


@pytest.mark.parametrize("render_size,case", [
    (2048, "test_highres_render"), (2048, "preprocess"), (512, "preprocess")])
def test_paste_back_matches_jax(render_size, case):
    rng = np.random.RandomState(render_size)
    faces = rng.randint(0, 778, (2, 1538, 3)).astype(np.int32)
    if case == "test_highres_render":     # tests/test_highres_render.py:10-19
        frame = (rng.rand(100, 60, 3) * 255).astype(np.uint8)
        offsets = np.array([100, 100, 0, 0, 0, 0, 0, 20, 0, 20], np.float32)
        rendered = np.full((render_size, render_size, 3), 50, np.uint8)
    else:                                 # a wide frame, padded top and bottom
        frame = (rng.rand(72, 128, 3) * 255).astype(np.uint8)
        offsets = img_preprocess(frame, None, 512)["offsets"][0]
        rendered = (rng.rand(render_size, render_size, 3) * 255
                    ).astype(np.uint8)
    want = JaxVisualizer(JaxConfig(render_size=render_size), faces
                         ).paste_back(rendered, frame, offsets)
    got = Visualizer(Config(render_size=render_size), faces, device="cpu"
                     ).paste_back(rendered, frame, offsets)
    scale = 4 if render_size > 1000 else 1
    assert got.shape == want.shape == (frame.shape[0] * scale,
                                       frame.shape[1] * scale, 3)
    np.testing.assert_array_equal(got, want)
    if case == "test_highres_render":
        assert (np.abs(got[200, 120].astype(int) - 50) <= 2).all()


@pytest.mark.parametrize("device_args", [[], ["--device", "cuda"],
                                         ["--device", "cuda:0"]])
def test_cli_raises_without_a_card(device_args, monkeypatch):
    from acr_tpu_torch.cli import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(["--demo_mode", "image", "--inputs", "x.jpg",
              "--model_path", "/nonexistent.npz", *device_args])


@pytest.fixture(scope="module")
def seeded_params():
    from acr_tpu_torch.io.params import init_params
    return init_params(torch.Generator().manual_seed(0))


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for item in x for t in _leaves(item)]
    return []


@pytest.mark.parametrize("entry", ["ACRApp", "ACRPipeline", "Visualizer",
                                   "load_mano_model", "init_channel",
                                   "init_hand_filter", "init_two_hand_filter"])
def test_entry_points_run_on_the_card_by_default(entry, seeded_params,
                                                 monkeypatch, tmp_path):
    """Repairs C3 and C4: the library entry points default to
    ``device="cuda"`` and raise without a card; the CPU runs only when
    asked for."""
    import inspect
    from acr_tpu_torch.models.mano import load_mano_model
    from acr_tpu_torch.pipeline import temporal
    from acr_tpu_torch.pipeline.app import ACRApp
    from acr_tpu_torch.pipeline.infer import ACRPipeline
    functions = {
        "load_mano_model": lambda **kw: load_mano_model(MANO_DIR, "left", **kw),
        "init_channel": lambda **kw: temporal.init_channel((45,), **kw),
        "init_hand_filter": lambda **kw: temporal.init_hand_filter(**kw),
        "init_two_hand_filter":
            lambda **kw: temporal.init_two_hand_filter(**kw)}
    if entry in functions:
        fn = (load_mano_model if entry == "load_mano_model"
              else getattr(temporal, entry))
        assert inspect.signature(fn).parameters["device"].default == "cuda"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            functions[entry]()
        leaves = _leaves(functions[entry](device="cpu"))
        assert leaves and all(t.device.type == "cpu" for t in leaves)
        return
    cls = {"ACRApp": ACRApp, "ACRPipeline": ACRPipeline,
           "Visualizer": Visualizer}[entry]
    assert inspect.signature(cls).parameters["device"].default == "cuda"
    cfg = Config(input_size=128, render_size=128, configs_yml="",
                 mano_model_path=MANO_DIR, centermap_conf_thresh=-1e9,
                 output_dir=str(tmp_path) + "/")
    make = {"ACRApp": lambda **kw: ACRApp(cfg, params=seeded_params, **kw),
            "ACRPipeline": lambda **kw: ACRPipeline(cfg, params=seeded_params,
                                                    **kw),
            "Visualizer": lambda **kw: Visualizer(
                cfg, np.zeros((2, 1538, 3), np.int32), **kw)}[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make()
    obj = make(device="cpu")
    if entry == "Visualizer":
        assert obj.faces.device.type == "cpu"
        return
    pipe = obj.pipeline if entry == "ACRApp" else obj
    assert pipe.device.type == "cpu"
    assert next(pipe.net.parameters()).device.type == "cpu"
    if entry == "ACRApp":
        frame = (np.random.RandomState(3).rand(96, 128, 3) * 255
                 ).astype(np.uint8)
        results = obj.process_frame(frame, "frame.jpg")
        assert len(results["frame.jpg"]) == 2
        assert obj.last_output["_rgba"].shape == (4, 128, 128)
