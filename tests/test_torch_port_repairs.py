"""The two repairs of the streaming slice.

* ``Visualizer.paste_back`` above 1000 px of render scales the frame and
  all ten offsets by 4 before the paste (acr_tpu/viz/visualizer.py:
  148-152); port and JAX must give the same pixels.
* The CLI's ``--device`` is ``cuda`` unless ``--device cpu`` is given,
  and without a card it raises instead of falling back to the CPU.
"""

import numpy as np
import pytest
import torch

from acr_tpu.config import Config as JaxConfig
from acr_tpu.viz.visualizer import Visualizer as JaxVisualizer
from acr_tpu_torch.config import Config
from acr_tpu_torch.pipeline.preprocess import img_preprocess
from acr_tpu_torch.viz.visualizer import Visualizer

torch.set_num_threads(2)


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
    got = Visualizer(Config(render_size=render_size), faces
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
