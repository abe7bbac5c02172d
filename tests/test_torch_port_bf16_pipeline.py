"""The port's bf16 ACRPipeline against the JAX package's at 128 px.

Weights as tests/test_torch_port_bf16.py's; JAX built canonical. The
parser's picks are compared only where the two sides pick the same
centre; a different pick must be a near-tie of JAX's map (its top two NMS
peaks within 2^-7 of each other, bf16's resolution). Compared hands:
params within 1e-2, verts within 1e-3 m; the returned maps within 0.03
mean relative error. And the JAX suite's own bf16 check
(tests/test_capture_and_misc.py:61-79): finite verts, betas within 1.0 of
fp32.
"""

import os

import numpy as np
import pytest
import torch

from acr_tpu.config import Config as JaxConfig
from acr_tpu.io.params import unflatten_params
from acr_tpu.pipeline.infer import ACRPipeline as JaxPipeline
from acr_tpu_torch.config import Config
from acr_tpu_torch.io.params import from_flax
from acr_tpu_torch.pipeline.infer import ACRPipeline
from test_torch_port_bf16 import BF16_EPS, _mean_rel, flat  # noqa: F401

torch.set_num_threads(2)
MANO_DIR = os.path.join(os.path.dirname(__file__), "..", "model_data", "mano")
CANONICAL = dict(s2d_highres=False, s2d_segm=False, s2d_stem=False,
                 merged_heads=False)


def _second_peak_gap(center_map):
    """Relative gap between the two highest NMS peaks of an (H, W) map."""
    from acr_tpu_torch.parser.center import nms_heatmap
    nms = nms_heatmap(torch.from_numpy(center_map)[None]).flatten()
    top2 = torch.topk(nms, 2).values
    return float((top2[0] - top2[1]) / top2[0].abs())


@pytest.fixture(scope="module")
def pipelines(flat):
    image = (np.random.RandomState(3).rand(1, 128, 128, 3) * 255).astype(np.uint8)
    offsets = np.array([[128, 128, 0, 0, 0, 0, 0, 0, 0, 0]], np.float32)
    kw = dict(input_size=128, mano_model_path=MANO_DIR, configs_yml="",
              centermap_conf_thresh=-1e9)
    jpipe = JaxPipeline(JaxConfig(model_precision="bf16", **kw, **CANONICAL),
                        params=unflatten_params(flat))
    want = {k: np.asarray(v) for k, v in
            jpipe(image, offsets, return_maps=True).items()}
    sd = from_flax(flat)
    pipes, out = {}, {}
    for prec in ("bf16", "fp32"):
        pipes[prec] = ACRPipeline(Config(model_precision=prec, **kw),
                                  params=sd, device="cpu")
        out[prec] = {k: v.numpy() for k, v in pipes[prec](
            image, offsets, return_maps=True).items()}
    return want, out["bf16"], out["fp32"], pipes["bf16"].net


def test_pipeline_bf16_matches_jax(pipelines):
    want, got, _, _ = pipelines
    assert got.keys() == want.keys()
    for key in ("l_center_map", "r_center_map", "segms", "verts", "j3d",
                "params", "poses", "betas", "cam_trans"):
        assert got[key].dtype == np.float32, key     # maps cast on return
    np.testing.assert_array_equal(got["detection_flag"], want["detection_flag"])
    compared = 0
    for hand, side in enumerate(("l", "r")):
        if np.array_equal(got["centers"][0, hand], want["centers"][0, hand]):
            compared += 1
            np.testing.assert_allclose(got["params"][0, hand],
                                       want["params"][0, hand], atol=1e-2)
            np.testing.assert_allclose(got["verts"][0, hand],
                                       want["verts"][0, hand], atol=1e-3)
        else:        # only a near-tie of JAX's own map may pick otherwise
            gap = _second_peak_gap(want[f"{side}_center_map"][0, ..., 0])
            assert gap < BF16_EPS, (side, gap)
    assert compared >= 1
    for key in ("l_center_map", "r_center_map", "segms"):
        assert _mean_rel(want[key], got[key]) < 0.03, key


def test_pipeline_bf16_against_fp32(pipelines):
    """The JAX suite's own bf16 check, held on the port."""
    _, got, ref, net = pipelines
    assert net.backbone.stem1.conv.weight.dtype == torch.bfloat16
    assert net.l_shape_fc.weight.dtype == torch.bfloat16
    assert np.isfinite(got["verts"]).all()
    assert np.abs(got["betas"] - ref["betas"]).max() < 1.0
    assert not np.array_equal(got["l_center_map"], ref["l_center_map"])
