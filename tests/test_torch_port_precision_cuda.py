"""The precision paths on the card (marked ``cuda``; they skip without
one). This file imports nothing of the JAX package, so it also collects
on a GPU host where flax does not import.

- ``int8_conv2d`` on CUDA (``torch._int_mm``) equals its float64 plain
  version and its CPU run bit for bit, at the shapes of the stem, the
  segm head, a fuse conv and a stride-2 transition.
- The bf16 pipeline on the card against the same pipeline on the CPU at
  128 px and b2 (``init_params`` weights with the fuse convs biased so
  both hands are plausible, as chip_smoke.py's): the same flags; where
  the two pick the same centre, verts within 1e-3 m (chip_smoke.py
  measured 2.3e-7 m at 512 px); a different pick must be a near-tie of
  the CPU's map (its top two NMS peaks within 2^-7 of each other).
"""

import os

import numpy as np
import pytest
import torch

from acr_tpu_torch.config import Config
from acr_tpu_torch.io.params import init_params
from acr_tpu_torch.ops import quant as tq
from acr_tpu_torch.parser.center import nms_heatmap
from acr_tpu_torch.pipeline.infer import ACRPipeline

MANO_DIR = os.path.join(os.path.dirname(__file__), "..", "model_data", "mano")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch._int_mm's CUDA path and cuDNN")


@pytest.mark.cuda
def test_int8_conv2d_cuda_bit_equal():
    _need_card()
    rng = np.random.RandomState(0)
    for b, ci, h, w, co, k, s, p in [(1, 3, 64, 64, 64, 3, 2, 1),
                                      (2, 64, 32, 32, 33, 3, 1, 1),
                                      (1, 218, 8, 8, 109, 1, 1, 0),
                                      (1, 256, 4, 4, 256, 3, 2, 1)]:
        xq = torch.from_numpy(rng.randint(-127, 128, (b, ci, h, w)).astype(
            np.int8)).cuda()
        wq = torch.from_numpy(rng.randint(-127, 128, (co, ci, k, k)).astype(
            np.int8)).cuda()
        got = tq.int8_conv2d(xq, wq, s, p)
        assert got.is_cuda and got.dtype == torch.int32
        assert torch.equal(got, tq.int8_conv2d_plain(xq, wq, s, p))
        assert torch.equal(got.cpu(), tq.int8_conv2d(xq.cpu(), wq.cpu(), s, p))


def _weights():
    params = init_params(torch.Generator().manual_seed(0))
    rot6d = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0]).repeat(16)
    for side, tx in (("l", -0.3), ("r", 0.3)):
        params[f"{side}_fuse_conv.weight"] *= 0.05
        params[f"{side}_fuse_conv.weight"][:3] = 0.0
        params[f"{side}_fuse_conv.bias"][:] = torch.cat([
            torch.tensor([3.0, tx, 0.0]), rot6d, torch.zeros(10)])
        params[f"{side}_prior_head.out.weight"] *= 0.05
    return params


@pytest.mark.cuda
def test_bf16_card_against_cpu():
    _need_card()
    image = (np.random.RandomState(3).rand(2, 128, 128, 3) * 255).astype(np.uint8)
    offsets = np.tile(np.array([[128, 128, 0, 0, 0, 0, 0, 0, 0, 0]],
                               np.float32), (2, 1))
    cfg = Config(input_size=128, mano_model_path=MANO_DIR, configs_yml="",
                 centermap_conf_thresh=-1e9, model_precision="bf16")
    params = _weights()
    out = {dev: {k: v.cpu().numpy() for k, v in ACRPipeline(
        cfg, params=params, device=dev)(image, offsets,
                                        return_maps=True).items()}
        for dev in ("cuda", "cpu")}
    gpu, cpu = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(gpu["detection_flag"], cpu["detection_flag"])
    for b in range(2):
        for hand, side in enumerate(("l", "r")):
            if np.array_equal(gpu["centers"][b, hand], cpu["centers"][b, hand]):
                np.testing.assert_allclose(gpu["verts"][b, hand],
                                           cpu["verts"][b, hand], atol=1e-3)
            else:
                nms = nms_heatmap(torch.from_numpy(
                    cpu[f"{side}_center_map"][b, ..., 0])[None]).flatten()
                top2 = torch.topk(nms, 2).values
                assert float((top2[0] - top2[1]) / top2[0].abs()) < 2.0 ** -7
    assert np.isfinite(gpu["segms"]).all()
