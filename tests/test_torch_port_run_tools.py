"""The port's run tools: quant_accuracy, profile_step and the dry runs.

``acr_tpu_torch.tools.quant_accuracy`` against ``tools/quant_accuracy.py``
on the same weights (``make_synthetic_checkpoint.make_params``, seed 0,
carried to flax) and frames at 64 px; JAX runs op by op
(``jax.disable_jit``), as tests/test_torch_port_quant_net.py does.
Tolerance: ``compare_outputs`` equal on the same arrays; ``run_eval``'s
metrics for ``int8`` within quant_net's 1e-3 mean relative error of
JAX's, with equal detection flips. ``profile_step`` and
``tools.dryrun`` run on the CPU at 64 px (``device="cpu"``): the
multichip dry run equals one replica bit for bit, the multi-process one
joins two interpreters over gloo within a time limit, and every entry
point raises without a card.
"""

import os

import numpy as np
import pytest
import torch

import jax

from acr_tpu.io.params import unflatten_params
from acr_tpu_torch.io.params import save_params_npz, to_flax
from acr_tpu_torch.tools import dryrun, profile_step
from acr_tpu_torch.tools import quant_accuracy as tq
from acr_tpu_torch.tools.make_synthetic_checkpoint import make_params
from tools import quant_accuracy as jq

torch.set_num_threads(2)
SIZE = 64
MEAN_REL = 1e-3          # tests/test_torch_port_quant_net.py


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(state dict, npz path) of the damped seed-0 synthetic weights."""
    params = make_params(0)
    path = str(tmp_path_factory.mktemp("ckpt") / "wild.npz")
    save_params_npz(path, params)
    return params, path


def test_compare_outputs_matches_jax():
    rng = np.random.RandomState(5)

    def outs(n):
        return [{"verts": rng.randn(2, 2, 778, 3),
                 "j3d": rng.randn(2, 2, 21, 3), "pj2d": rng.randn(2, 2, 21, 2),
                 "cam_trans": rng.randn(2, 2, 3),
                 "detection_flag": rng.rand(2, 2) > 0.5,
                 "centers_conf": rng.rand(2, 2)} for _ in range(n)]
    ref, q = outs(3), outs(3)
    assert tq.compare_outputs(ref, q, SIZE) == jq.compare_outputs(ref, q, SIZE)


def test_run_eval_int8_matches_jax(weights, tmp_path, monkeypatch):
    import cv2
    params, _ = weights
    # the same frames on both sides: a seeded photo (JAX's is its
    # MAGIC path, the port's its image argument) and one synthetic frame
    photo = str(tmp_path / "photo.png")
    cv2.imwrite(photo, (np.random.RandomState(3).rand(90, 120, 3) * 255)
                .astype(np.uint8))
    monkeypatch.setattr(jq, "MAGIC", photo)
    got = tq.run_eval(params, input_size=SIZE, modes=("int8",), n_synth=1,
                      device="cpu", image=photo)
    with jax.disable_jit():
        want = jq.run_eval(unflatten_params(to_flax(params)), input_size=SIZE,
                           modes=("int8",), n_synth=1)
    assert set(got) == set(want) == {"int8/default", "int8/frames"}
    for cfg in want:
        g, w = got[cfg], want[cfg]
        assert g["detection_flips"] == w["detection_flips"], cfg
        keys = [k for k in w if isinstance(w[k], float)]
        gv = np.array([g[k] for k in keys])
        wv = np.array([w[k] for k in keys])
        assert np.isfinite(gv).all() and (gv > 0).all(), (cfg, g)
        rel = np.abs(gv - wv).sum() / np.abs(wv).sum()
        assert rel < MEAN_REL, (cfg, rel, g, w)


def test_quant_accuracy_cli_prints_table(weights, tmp_path, capsys):
    _, path = weights
    out = str(tmp_path / "acc.json")
    results = tq.main(["--input_size", str(SIZE), "--modes", "int8_pc",
                       "--n_synth", "1", "--model_path", path,
                       "--json_out", out, "--device", "cpu"])
    text = capsys.readouterr().out
    assert "| config | vert_rel_mean_pct" in text
    assert "| int8_pc/default |" in text and "| int8_pc/frames |" in text
    assert os.path.exists(out) and set(results) == {"int8_pc/default",
                                                    "int8_pc/frames"}


def test_reference_init_needs_the_reference_tree(tmp_path):
    missing = str(tmp_path / "reference")
    with pytest.raises(FileNotFoundError, match="reference implementation"):
        tq.main(["--reference_init", missing, "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match=missing):
        tq.reference_init_params(missing)
    with pytest.raises(SystemExit):          # the tree has no default
        tq.main(["--reference_init", "--device", "cpu"])


def test_build_frames_takes_a_photo_only_when_named(tmp_path):
    assert [n for n, _ in tq.build_frames(SIZE, n_synth=1)] == ["synthetic_0"]
    with pytest.raises(FileNotFoundError, match="absent.jpg"):
        tq.build_frames(SIZE, n_synth=1, image=str(tmp_path / "absent.jpg"))


def test_profile_step_cpu_table(weights, tmp_path, capsys):
    _, path = weights
    rows = profile_step.main([
        "--device", "cpu", "--batch", "2", "--iters", "2", "--top", "8",
        "--precision", "fp32", "--input_size", str(SIZE), "--model_path",
        path, "--trace_dir", str(tmp_path / "trace")])
    text = capsys.readouterr().out
    assert "# total self CPU time" in text and "# by category" in text
    assert "conv/GEMM" in text
    assert rows and all(r["self_us"] > 0 for r in rows)
    assert rows[0]["category"] == "conv/GEMM"
    assert len(os.listdir(tmp_path / "trace")) == 1
    assert profile_step.category("mano_split_kernel(float const*)") == \
        "port kernels"
    assert profile_step.category("Memcpy HtoD (Pageable -> Device)") == \
        "copies"


# kernel names in PyTorch's form, as a card's trace gives them
_MUL = ("void at::native::elementwise_kernel<128, 4, at::native::"
        "gpu_kernel_impl_nocast<at::native::BinaryFunctor<float, float, "
        "float, at::native::binary_internal::MulFunctor<float> > >"
        "(at::TensorIteratorBase&, at::native::BinaryFunctor<float, float, "
        "float, at::native::binary_internal::MulFunctor<float> > const&)::"
        "{lambda(int)#1}>(int, ...)")
_CLAMP = ("void at::native::vectorized_elementwise_kernel<8, at::native::"
          "(anonymous namespace)::launch_clamp_scalar(at::TensorIteratorBase&,"
          " c10::Scalar, c10::Scalar, at::native::detail::ClampLimits)::"
          "{lambda()#1}::operator()() const::{lambda(float)#1}, "
          "std::array<char*, 2ul> >(int, ...)")
_ADD = ("void at::native::vectorized_elementwise_kernel<8, at::native::"
        "CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul> >(int, "
        "at::native::CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul>)")
_COPY = ("void at::native::elementwise_kernel<128, 4, at::native::"
         "gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda("
         "at::TensorIteratorBase&)::{lambda()#3}::operator()() const::"
         "{lambda(float)#1}>(at::TensorIteratorBase&, ...)")
_NCHW = ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, "
         "__nv_bfloat16, float, false, true, (cudnnKernelDataType_t)2>(...)")


@pytest.mark.parametrize("name,want_label,want_category", [
    (_MUL, "elementwise_kernel[MulFunctor]", "elementwise"),
    (_CLAMP, "vectorized_elementwise_kernel[launch_clamp_scalar]",
     "elementwise"),
    (_ADD, "vectorized_elementwise_kernel[CUDAFunctor_add]", "elementwise"),
    (_COPY, "elementwise_kernel[direct_copy_kernel_cuda]", "copies"),
    (_NCHW, _NCHW, "copies"),
], ids=["mul", "clamp", "add", "copy", "cudnn_layout"])
def test_profile_step_names_pytorch_kernels(name, want_label, want_category):
    assert profile_step.label(name) == want_label
    assert profile_step.category(name) == want_category


def test_dryrun_multichip_equals_one_replica(weights):
    _, path = weights
    out = dryrun.dryrun_multichip(2, input_size=SIZE, device="cpu",
                                  model_path=path, render_size=SIZE)
    assert out["verts"].shape == (2, 2, 778, 3)
    assert np.isfinite(out["verts"]).all()
    # the shards are different frames: the outputs differ between them
    assert not np.array_equal(out["verts"][0], out["verts"][1])


def test_dryrun_multiprocess_over_gloo(weights, capsys):
    _, path = weights
    dryrun.dryrun_multiprocess(2, 1, device="cpu", model_path=path,
                               timeout=300)
    assert "dryrun_multiprocess(2x1): OK" in capsys.readouterr().out


def test_entry_points_raise_without_a_card(weights):
    _, path = weights
    for call in (lambda: dryrun.entry(model_path=path),
                 lambda: dryrun.dryrun_multichip(2, SIZE, model_path=path),
                 lambda: dryrun.dryrun_multiprocess(2, 1, model_path=path),
                 lambda: profile_step.main(["--model_path", path]),
                 lambda: tq.main(["--model_path", path])):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


def test_entry_on_the_cpu(weights):
    _, path = weights
    fn, (image, offsets) = dryrun.entry(device="cpu", model_path=path)
    assert image.shape == (1, 512, 512, 3) and image.dtype == torch.uint8
    out = fn(image, offsets)
    assert out["verts"].shape == (1, 2, 778, 3)
    assert torch.isfinite(out["verts"]).all()
