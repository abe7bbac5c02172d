"""The port's checkpoint conversion against the JAX side's.

``acr_tpu_torch.io.torch_names``, ``io.params.flax_paths`` / ``to_flax``
/ ``save_params_npz`` and ``acr_tpu_torch.tools.convert_checkpoint``
against ``acr_tpu.io.torch_names``, ``tools/convert_checkpoint.py`` and
``acr_tpu.io.params``. The reference state dict is synthetic, with the
reference's key names and layouts, from a numpy seed (as
tests/test_checkpoint_convert.py builds it). Tolerances: the name map,
the path set, the shapes and every converted array are equal (bit for
bit, ``assert_array_equal``); the forward of the converted npz at 64 px
is within tests/test_torch_port_model.py's ATOL (1e-4) of JAX's.
"""

import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acr_tpu.io import params as jparams
from acr_tpu.io.torch_names import map_flax_path as jax_map_flax_path
from acr_tpu.models.acr import ACRNet as JaxACRNet
from acr_tpu_torch.io import params as tparams
from acr_tpu_torch.io.torch_names import map_flax_path
from acr_tpu_torch.models.acr import ACRNet
from acr_tpu_torch.tools import convert_checkpoint as tconv
from test_torch_port_model import ATOL
from tools import convert_checkpoint as jconv

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_paths():
    """JAX's enumerate_flax_paths and the shapes of its eval_shape."""
    paths = jconv.enumerate_flax_paths()
    shapes = jax.eval_shape(lambda: JaxACRNet().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 512, 512, 3), jnp.uint8)))
    out = collections.OrderedDict()
    for path in paths:
        node = shapes["params"]
        for k in path:
            node = node[k]
        out[tuple(path)] = tuple(node.shape)
    return out


def _reference_sd(jax_paths, seed, fusion=False):
    """Torch-layout arrays under the reference's key names (float32)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for path, shape in jax_paths.items():
        base, kind = jax_map_flax_path(path)
        if kind == "conv_kernel":
            kh, kw, ci, co = shape
            sd[base + ".weight"] = rng.randn(co, ci, kh, kw)
        elif kind in ("conv_bias", "dense_bias"):
            sd[base + ".bias"] = rng.randn(*shape)
        elif kind == "dense_kernel":
            ci, co = shape
            sd[base + ".weight"] = rng.randn(co, ci)
        elif kind == "lc_weight":
            sd[base + ".weight"] = rng.randn(1, *shape, 1, 1)
        elif kind == "bn" and base + ".weight" not in sd:
            n = shape[0]
            sd[base + ".weight"] = rng.rand(n) + 0.5
            sd[base + ".bias"] = rng.randn(n)
            sd[base + ".running_mean"] = rng.randn(n)
            sd[base + ".running_var"] = rng.rand(n) + 0.2
    sd["segmentation_layers.1.0.weight"] = rng.randn(256, 34, 3, 3)
    if fusion:
        sd["_result_parser.fusion_fc_end.weight"] = rng.randn(212, 424)
        sd["_result_parser.fusion_fc_end.bias"] = rng.randn(212)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def test_map_flax_path_matches_jax(jax_paths):
    for path in jax_paths:
        assert map_flax_path(path) == jax_map_flax_path(path), path
    with pytest.raises(KeyError):
        map_flax_path(("nope", "kernel"))


def test_flax_paths_match_enumerate(jax_paths):
    got = tparams.flax_paths()
    assert set(got) == set(jax_paths)
    assert list(got) == list(jax_paths)          # JAX's order too
    assert got == dict(jax_paths)
    assert tconv.enumerate_flax_paths() == list(jax_paths)


def test_to_flax_inverts_from_flax(jax_paths):
    rng = np.random.RandomState(3)
    flat = {"/".join(p): rng.randn(*s).astype(np.float32)
            for p, s in jax_paths.items()}
    back = tparams.to_flax(tparams.from_flax(flat))
    assert list(back) == list(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("dtype,fusion", [
    (np.float32, False), (np.float16, False), (np.float32, True)])
def test_convert_state_dict_bit_equal_to_jax(jax_paths, dtype, fusion):
    sd = {k: v.astype(dtype) for k, v in
          _reference_sd(jax_paths, 0, fusion).items()}
    paths = list(jax_paths)
    want, want_used, want_missing = jconv.convert_state_dict(sd, paths)
    jconv.carry_parser_heads(sd, want, want_used)
    got, used, missing = tconv.convert_state_dict(sd, paths)
    tconv.carry_parser_heads(sd, got, used)
    assert missing == want_missing == []
    assert used == want_used
    assert list(got) == list(want)
    assert ("parser/fusion_fc/kernel" in got) == fusion
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the fold itself, in numpy float32
    g, v = sd["backbone.bn1.weight"], sd["backbone.bn1.running_var"]
    scale = g.astype(np.float32) / np.sqrt(v.astype(np.float32) + 1e-5)
    np.testing.assert_array_equal(got["backbone/stem1/bn/scale"], scale)


def test_save_params_npz_is_jax_npz(tmp_path):
    params = tparams.init_params(torch.Generator().manual_seed(1))
    fc = {"weight": torch.randn(212, 424, generator=torch.Generator()
                                .manual_seed(2)),
          "bias": torch.zeros(212)}
    tparams.save_params_npz(str(tmp_path / "port.npz"), params, fc)
    flat = tparams.to_flax(params)
    flat["parser/fusion_fc/kernel"] = fc["weight"].numpy().T
    flat["parser/fusion_fc/bias"] = fc["bias"].numpy()
    jparams.save_params_npz(str(tmp_path / "jax.npz"),
                            jparams.unflatten_params(flat))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert a.files == b.files
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    loaded, fusion = tparams.load_params(str(tmp_path / "port.npz"))
    assert all(torch.equal(loaded[k], v) for k, v in params.items())
    assert torch.equal(fusion["weight"], fc["weight"])


# ---------------------------------------------------------------------------
# checkpoint containers (tests/test_checkpoint_convert.py:142-203), each
# through the port's _to_numpy_state_dict and held against JAX's
# ---------------------------------------------------------------------------

def _tiny():
    g = torch.Generator().manual_seed(0)
    return {"backbone.conv1.weight": torch.randn(8, 3, 3, 3, generator=g),
            "backbone.bn1.weight": torch.rand(8, generator=g) + 0.5}


def _container(case):
    if case == "bare":
        return _tiny()
    if case == "module_prefixed":
        return collections.OrderedDict(
            ("module." + k, v) for k, v in _tiny().items())
    if case == "double_module_prefix":
        return {"module.module." + k: v for k, v in _tiny().items()}
    if case in ("model_state_dict", "state_dict", "model"):
        return {case: {"module." + k: v for k, v in _tiny().items()},
                "optimizer": {"state": {}, "param_groups": [{"lr": 1e-4}]},
                "epoch": 17, "best_score": 0.5}
    if case == "fp16_tensors":
        return {"module." + k: v.half() for k, v in _tiny().items()}
    if case == "non_tensor_entries":
        obj = dict(_tiny())
        obj.update(epoch=3, note="trained on interhand", nothing=None)
        return obj
    if case == "whole_module":
        torch.manual_seed(0)
        return torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3))
    if case == "unsupported":
        return [1, 2, 3]
    raise KeyError(case)


CASES = ("bare", "module_prefixed", "double_module_prefix",
         "model_state_dict", "state_dict", "model", "fp16_tensors",
         "non_tensor_entries", "whole_module", "unsupported")


@pytest.mark.parametrize("case", CASES)
def test_container(tmp_path, case):
    path = str(tmp_path / f"{case}.pkl")
    torch.save(_container(case), path)
    if case == "unsupported":
        for fn in (tconv._to_numpy_state_dict, jconv._to_numpy_state_dict):
            with pytest.raises(ValueError, match="unsupported checkpoint"):
                fn(path)
        return
    got = tconv._to_numpy_state_dict(path)
    want = jconv._to_numpy_state_dict(path)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    if case == "whole_module":
        assert got["0.weight"].shape == (4, 3, 3, 3)
    elif case == "non_tensor_entries":
        assert "note" not in got and "nothing" not in got
        assert got["epoch"].shape == ()
    else:
        assert set(got) == {"backbone.conv1.weight", "backbone.bn1.weight"}
        if case == "fp16_tensors":
            assert got["backbone.conv1.weight"].dtype == np.float16


def test_converted_npz_forward_matches_jax(tmp_path, jax_paths):
    """The port's converter CLI on an fp16 ``module.``-wrapped stand-in
    writes JAX's npz; both packages load it, and the forward at 64 px
    agrees within ATOL."""
    sd = tconv.stand_in_state_dict(seed=5)
    ckpt = str(tmp_path / "wild.pkl")
    torch.save({"module." + k: torch.from_numpy(v).half()
                for k, v in sd.items()}, ckpt)
    tconv.main(["--torch_ckpt", ckpt, "--out", str(tmp_path / "port.npz")])
    jconv.main(["--torch_ckpt", ckpt, "--out", str(tmp_path / "jax.npz")])
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert a.files == b.files
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    image = (np.random.RandomState(7).rand(1, 64, 64, 3) * 255).astype(np.uint8)
    jtree = jparams.load_params_npz(str(tmp_path / "port.npz"))
    want = jax.jit(JaxACRNet().apply)(jtree, jnp.asarray(image))
    state_dict, fusion = tparams.load_params(str(tmp_path / "port.npz"))
    assert fusion is None
    net = ACRNet()
    net.load_state_dict(state_dict)
    net.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(image))
    assert set(got) == set(want)
    for key in want:
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), key
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=key)
