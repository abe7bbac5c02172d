"""acr_tpu_torch.ops.quant (W8A8 int8) against acr_tpu.ops.quant.

Inputs and weights come from numpy seeds (the network's float weights
from ``init_params``, carried to flax by ``to_flax``). Tolerances, each
stated where it is asserted:
- int32 accumulators: ``int8_conv2d`` equals its float64 plain version
  and XLA's int8 convolution bit for bit;
- ``QuantConv`` outputs: 1e-6 relative in fp32, one bf16 rounding in bf16;
- ``quantize_tree_int8``: ``kernel_q``, ``wscale`` and ``ascale``
  bit-equal to JAX's on the same stats;
- through the pipeline: the output-space budget of
  tests/test_quant.py:160-197 (mean per-vertex displacement below 1 % of
  the hand's bbox diagonal against the same run in float, no flipped
  detection flag).
"""

import os

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from acr_tpu.io.params import flatten_params, unflatten_params
from acr_tpu.ops import quant as jq
from acr_tpu_torch.config import Config
from acr_tpu_torch.io.params import from_flax, init_params, to_flax
from acr_tpu_torch.models.acr import ACRNet
from acr_tpu_torch.ops import quant as tq
from acr_tpu_torch.pipeline.infer import ACRPipeline
from acr_tpu_torch.pipeline.preprocess import img_preprocess

torch.set_num_threads(2)
MANO_DIR = os.path.join(os.path.dirname(__file__), "..", "model_data", "mano")
MODES = ("int8", "int8_pc", "int8_r", "int4w")


def jax_stats(stats):
    """Port stats {conv name: amax} -> JAX's nested quant_stats tree."""
    tree = {}
    for name, amax in stats.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[f"amax_{leaf}"] = (np.asarray(amax, np.float32),)
    return tree


def flat_jax_stats(tree, prefix=""):
    """JAX's nested quant_stats -> {port conv name: amax vector}."""
    out = {}
    for key, val in tree.items():
        if key.startswith("amax_"):
            out[prefix + key[len("amax_"):]] = np.asarray(
                val[0] if isinstance(val, tuple) else val).reshape(-1)
        else:
            out.update(flat_jax_stats(val, prefix + key + "."))
    return out


def quant_names(net):
    return sorted(n for n, m in net.named_modules()
                  if isinstance(m, tq.QuantConv))


@pytest.fixture(scope="module")
def state_dict():
    return init_params(torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def image():
    return (np.random.RandomState(7).rand(1, 64, 64, 3) * 255).astype(np.uint8)


def _int8_params(rng, kernel, ci, co, per_channel):
    kq = rng.randint(-127, 128, (kernel, kernel, ci, co)).astype(np.int8)
    ws = (rng.rand(co) * 0.01 + 1e-3).astype(np.float32)
    asc = np.float32(rng.rand(*((ci,) if per_channel else ())) * 40 + 5)
    bias = rng.randn(co).astype(np.float32)
    return {"kernel_q": kq, "wscale": ws, "ascale": np.asarray(asc),
            "bias": bias}


CONV_SHAPES = [  # (kernel, stride, pad, Ci, Co)
    (3, 1, 1, 5, 7), (3, 2, 1, 8, 16), (1, 1, 0, 12, 3), (1, 2, 0, 9, 10),
    (3, 1, 1, 33, 33), (3, 2, 1, 3, 64)]


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_quantconv_matches_jax(shape, per_channel):
    kernel, stride, pad, ci, co = shape
    rng = np.random.RandomState(sum(shape) + per_channel)
    p = _int8_params(rng, kernel, ci, co, per_channel)
    x = (rng.randn(2, 11, 9, ci) * 3).astype(np.float32)
    jmod = jq.QuantConv(co, kernel=kernel, stride=stride, pad=pad,
                        use_bias=True, per_channel=per_channel)
    tmod = tq.QuantConv(ci, co, kernel, stride, pad, use_bias=True,
                        per_channel=per_channel).requires_grad_(False)
    tmod.load_state_dict({"kernel_q": torch.from_numpy(
        p["kernel_q"].transpose(3, 2, 0, 1).copy()),
        "wscale": torch.from_numpy(p["wscale"]),
        "ascale": torch.from_numpy(p["ascale"]),
        "bias": torch.from_numpy(p["bias"])})
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())

    # the int32 accumulators: the same int8 operands, bit for bit
    xq = np.clip(np.round(x * p["ascale"]), -127, 127).astype(np.int8)
    acc_j = np.asarray(jax.lax.conv_general_dilated(
        xq, p["kernel_q"], (stride, stride), ((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    acc_t = tq.int8_conv2d(torch.from_numpy(xq.transpose(0, 3, 1, 2).copy()),
                           tmod.kernel_q, stride, pad)
    assert acc_t.dtype == torch.int32
    np.testing.assert_array_equal(acc_t.numpy().transpose(0, 2, 3, 1), acc_j)

    # the dequantized output, fp32 to 1e-6 relative
    want = np.asarray(jmod.apply({"params": p}, x))
    got = tmod(xt).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    # in bf16: the same values to one bf16 rounding
    jmod16 = jq.QuantConv(co, kernel=kernel, stride=stride, pad=pad,
                          use_bias=True, per_channel=per_channel,
                          dtype=jnp.bfloat16)
    want16 = np.asarray(jmod16.apply({"params": p}, jnp.asarray(
        x, jnp.bfloat16)).astype(jnp.float32))
    got16 = tmod(xt.bfloat16())
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy().transpose(0, 2, 3, 1),
                               want16, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want16).max())


@pytest.mark.parametrize("shape", [  # (B, Ci, H, W, Co, kernel, stride, pad)
    (1, 3, 4, 4, 5, 3, 1, 1),          # M = 16: rows padded to 17
    (2, 27, 9, 7, 33, 3, 2, 1),        # K = 243, N = 33: padded to 8s
    (1, 64, 16, 16, 64, 1, 1, 0),      # aligned: no padding
    (3, 218, 5, 5, 109, 1, 1, 0),      # a fuse conv under '_r'
    (1, 33, 12, 12, 33, 3, 1, 1),      # the segm head's out_conv2
])
def test_int8_conv2d_matches_plain(shape):
    b, ci, h, w, co, k, s, p = shape
    rng = np.random.RandomState(h * w + ci)
    xq = torch.from_numpy(rng.randint(-127, 128, (b, ci, h, w)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (co, ci, k, k)).astype(np.int8))
    got = tq.int8_conv2d(xq, wq, s, p)
    want = tq.int8_conv2d_plain(xq, wq, s, p)
    assert got.dtype == want.dtype == torch.int32
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_quantize_tree_int8_matches_jax(state_dict, mode):
    with torch.device("meta"):
        names = [n for n, m in ACRNet().named_modules()
                 if isinstance(m, nn.Conv2d) and tq.is_quant_site(n, mode)]
    rng = np.random.RandomState(len(mode))
    stats = {}
    for name in names:
        ci = state_dict[f"{name}.weight"].shape[1]
        amax = (rng.rand(ci) * 4).astype(np.float32)
        amax[rng.rand(ci) < 0.2] = 1e-7        # dead channels hit the floor
        stats[name] = amax
    per_channel, bits = mode.endswith("_pc"), 4 if mode == "int4w" else 8
    want = jq.quantize_tree_int8(unflatten_params(to_flax(state_dict)),
                                 jax_stats(stats), per_channel=per_channel,
                                 weight_bits=bits)
    with torch.device("meta"):
        qnet = ACRNet(quantize=mode)
    want = from_flax(flatten_params(want), net=qnet)
    got = tq.quantize_tree_int8(state_dict, stats, per_channel=per_channel,
                                weight_bits=bits)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert torch.equal(got[key], want[key]), key
    kq = got["backbone.stem1.conv.kernel_q"]
    assert int(kq.abs().max()) == (7 if mode == "int4w" else 127)


def test_calibration_frames_equal_jax():
    got, want = tq.committed_calibration_frames(512), \
        jq.committed_calibration_frames(512)
    assert got is not None and len(got) == len(want) >= 6
    for g, w in zip(got, want):
        assert g.shape == (1, 512, 512, 3) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    assert tq.committed_calibration_frames(128) is None
    assert jq.committed_calibration_frames(128) is None
    for g, w in zip(tq.default_calibration_frames(64),
                    jq.default_calibration_frames(64)):
        np.testing.assert_array_equal(g, w)


def _vert_budget(ref, out):
    fv = ref["verts"].double().numpy()
    qv = out["verts"].double().numpy()
    disp = np.linalg.norm(qv - fv, axis=-1)
    diag = np.linalg.norm(fv.max(-2) - fv.min(-2), axis=-1)
    rel = disp / np.maximum(diag[..., None], 1e-9)
    flips = int((out["detection_flag"] != ref["detection_flag"]).sum())
    return float(rel.mean()), flips


@pytest.fixture(scope="module")
def frames():
    rng = np.random.RandomState(1)
    return [img_preprocess((rng.rand(200, 300, 3) * 255).astype(np.uint8),
                           f"f{i}.jpg", input_size=128) for i in range(2)]


@pytest.fixture(scope="module")
def float_outputs(state_dict, frames):
    """The float pipeline's outputs on ``frames``, per precision."""
    outs = {}
    for precision in ("fp32", "bf16"):
        pipe = ACRPipeline(Config(input_size=128, mano_model_path=MANO_DIR,
                                  configs_yml="", model_precision=precision),
                           params=state_dict, device="cpu")
        outs[precision] = [pipe(m["image"], m["offsets"]) for m in frames]
    return outs


@pytest.mark.parametrize("precision,mode", [
    ("fp32", "int8"), ("bf16", "int8"), ("bf16", "int8_pc"),
    ("bf16", "int8_r"), ("bf16", "int4w")])
def test_pipeline_quantized(state_dict, frames, float_outputs, precision,
                            mode, caplog):
    """ACRPipeline calibrates at load (no committed set at 128 px: the
    synthetic pair, with a warning), recalibrates on frames, and stays
    inside tests/test_quant.py's output-space budget against the same
    precision in float ('int8_r' and 'int4w' only run finite there)."""
    cfg = dict(input_size=128, mano_model_path=MANO_DIR, configs_yml="",
               model_precision=precision)
    with caplog.at_level("WARNING", logger="acr_tpu_torch"):
        qpipe = ACRPipeline(Config(quantize=mode, **cfg), params=state_dict,
                            device="cpu")
    assert "SYNTHETIC" in caplog.text
    stem = qpipe.net.backbone.stem1.conv
    assert isinstance(stem, tq.QuantConv) and stem.kernel_q.dtype == torch.int8
    assert stem.wscale.dtype == torch.float32
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    assert qpipe.net.backbone.stem1.bn.scale.dtype == dtype
    assert qpipe._float_params["backbone.stem1.conv.weight"].dtype == \
        torch.float32
    qpipe.calibrate([m["image"] for m in frames])
    rels, flips = [], 0
    for meta, ref in zip(frames, float_outputs[precision]):
        out = qpipe(meta["image"], meta["offsets"])
        for key in ("verts", "j3d", "cam_trans", "poses", "betas"):
            assert torch.isfinite(out[key]).all(), key
            assert out[key].dtype == torch.float32, key
        rel, flip = _vert_budget(ref, out)
        rels.append(rel)
        flips += flip
    if mode in ("int8", "int8_pc"):
        assert np.mean(rels) < 0.01, rels        # <1% of the bbox diagonal
        assert flips == 0


def test_calibrate_needs_a_quantized_pipeline(state_dict):
    pipe = ACRPipeline(Config(input_size=64, mano_model_path=MANO_DIR,
                              configs_yml=""), params=state_dict, device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        pipe.calibrate()
