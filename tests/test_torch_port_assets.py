"""The port's asset tools against the JAX side's.

``acr_tpu_torch.tools.{convert_mano, make_synthetic_mano,
make_synthetic_checkpoint, make_calib_frames, ingest_real_assets}``
against ``tools/`` and ``acr_tpu``. The MANO stand-ins are the committed
synthetic assets (``model_data/mano``) in the download's layout
(``convert_mano.reference_layout``: float64, raw key names, left
shapedirs unflipped), pickled at protocol 2 (as MANO's were) and at the
current protocol, with a sparse or a dense ``J_regressor``, or with
chumpy objects (a stand-in ``chumpy.ch.Ch`` that is gone again when the
converters unpickle). The checkpoint stand-in is
``convert_checkpoint.stand_in_state_dict`` saved by ``torch.save`` in
fp16 under ``module.``. Tolerance: bit for bit everywhere
(``assert_array_equal`` and equal dtypes), except the random weights of
``make_synthetic_checkpoint``, whose streams differ from JAX's: there
the key set, the shapes and the damped values are held.
"""

import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from acr_tpu.io.params import load_params_npz
from acr_tpu.pipeline.preprocess import img_preprocess as jax_preprocess
from acr_tpu_torch.io.params import load_params
from acr_tpu_torch.pipeline.preprocess import img_preprocess
from acr_tpu_torch.tools import convert_checkpoint as tconv
from acr_tpu_torch.tools import convert_mano as tmano
from acr_tpu_torch.tools import ingest_real_assets as tingest
from acr_tpu_torch.tools import make_calib_frames as tcalib
from acr_tpu_torch.tools import make_synthetic_checkpoint as tckpt
from acr_tpu_torch.tools import make_synthetic_mano as tsynth
from tools import convert_checkpoint as jconv
from tools import convert_mano as jmano
from tools import ingest_real_assets as jingest
from tools import make_calib_frames as jcalib
from tools import make_synthetic_mano as jsynth

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANO_DIR = os.path.join(REPO, "model_data", "mano")
SIDES = {"left": "MANO_LEFT.pkl", "right": "MANO_RIGHT.pkl"}


def _committed(side):
    with np.load(os.path.join(MANO_DIR, f"mano_{side}.npz")) as z:
        return {k: z[k] for k in z.files}


def assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _chumpy_ch():
    """A stand-in ``chumpy.ch`` module whose ``Ch`` pickles as a chumpy
    object does: its state carries the data in 'x'."""
    def init(self, x):
        self.x = x
        self.dterms = ("x",)
    mod = types.ModuleType("chumpy.ch")
    mod.Ch = type("Ch", (), {"__module__": "chumpy.ch", "__init__": init})
    return mod


def write_mano_pkls(out_dir, protocol=2, form="sparse"):
    """MANO_{LEFT,RIGHT}.pkl stand-ins from the committed assets."""
    os.makedirs(out_dir, exist_ok=True)
    for side, name in SIDES.items():
        raw = tmano.reference_layout(_committed(side))
        if form == "dense":
            raw["J_regressor"] = raw["J_regressor"].toarray()
        with pytest.MonkeyPatch.context() as mp, \
                open(os.path.join(out_dir, name), "wb") as f:
            if form == "chumpy":    # importable only while it is written
                ch = _chumpy_ch()
                mp.setitem(sys.modules, "chumpy", types.ModuleType("chumpy"))
                mp.setitem(sys.modules, "chumpy.ch", ch)
                for k in ("v_template", "shapedirs", "posedirs", "weights",
                          "hands_mean"):
                    raw[k] = ch.Ch(raw[k])
            pickle.dump(raw, f, protocol=protocol)


@pytest.mark.parametrize("form", ["sparse", "dense", "chumpy"])
@pytest.mark.parametrize("protocol", [2, pickle.HIGHEST_PROTOCOL])
def test_convert_mano_matches_jax(tmp_path, form, protocol):
    write_mano_pkls(str(tmp_path), protocol, form)
    assert "chumpy" not in sys.modules      # the converters use their stubs
    for side, name in SIDES.items():
        path = str(tmp_path / name)
        got = tmano.convert(path, side)
        assert_same_arrays(got, jmano.convert(path, side))
        # the left flip is baked back in: the committed assets again
        assert_same_arrays(got, _committed(side))


def test_convert_mano_cli(tmp_path):
    write_mano_pkls(str(tmp_path / "pkl"))
    tmano.main(["--mano_dir", str(tmp_path / "pkl"),
                "--out_dir", str(tmp_path / "npz")])
    for side in SIDES:
        with np.load(tmp_path / "npz" / f"mano_{side}.npz") as z:
            assert_same_arrays({k: z[k] for k in z.files}, _committed(side))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("side", ["left", "right"])
def test_make_synthetic_mano_matches_jax(side, seed):
    assert_same_arrays(tsynth.make_assets(side, seed),
                       jsynth.make_assets(side, seed))


def test_make_synthetic_checkpoint(tmp_path):
    out = str(tmp_path / "ckpt" / "wild.npz")
    tckpt.main(["--out", out, "--seed", "1"])
    paths = jconv.enumerate_flax_paths()
    jtree = load_params_npz(out)["params"]
    with np.load(out) as z:
        flat = {k: z[k] for k in z.files}
    assert list(flat) == ["/".join(p) for p in paths]
    for path in paths:
        node = jtree
        for k in path:
            node = node[k]
        assert node.shape == flat["/".join(path)].shape
    state_dict, fusion = load_params(out)
    assert fusion is None and len(state_dict) == len(paths)
    for name, arr in flat.items():
        assert arr.dtype == np.float32, name
        if name.endswith("/scale"):
            np.testing.assert_array_equal(arr, np.float32(0.2), err_msg=name)
        elif name.endswith(("center_head/out/bias",)):
            np.testing.assert_array_equal(arr, np.float32(0.5), err_msg=name)
        elif name.endswith("/bias"):
            np.testing.assert_array_equal(arr, np.float32(0.0), err_msg=name)
    # seeded: the same seed writes the same weights
    again = tckpt.make_params(1)
    assert all(torch.equal(again[k], v) for k, v in state_dict.items())


def _seeded_bgr():
    return (np.random.RandomState(11).rand(360, 1200, 3) * 255).astype(np.uint8)


def test_calib_variants_and_preprocess_match_jax(tmp_path):
    import cv2
    bgr = _seeded_bgr()
    got = list(tcalib.derive_variants(bgr))
    want = list(jcalib.derive_variants(bgr))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
        gm, wm = img_preprocess(g, name, 64), jax_preprocess(w, name, 64)
        np.testing.assert_array_equal(gm["image"], wm["image"], err_msg=name)
        np.testing.assert_array_equal(gm["offsets"], wm["offsets"])
    # build() and the CLI on the photo: JAX's frames, and the committed
    # set is left as it is
    photo = str(tmp_path / "photo.png")
    cv2.imwrite(photo, bgr)
    committed = os.path.join(REPO, "model_data", "calib", "calib_frames.npz")
    before = os.stat(committed).st_mtime_ns
    frames, names = tcalib.build(64, photo)
    assert frames.shape == (9, 64, 64, 3) and frames.dtype == np.uint8
    want = [np.asarray(jax_preprocess(img, n, 64)["image"][0])
            for n, img in jcalib.derive_variants(cv2.imread(photo))]
    np.testing.assert_array_equal(frames[:7], np.stack(want))
    assert list(names[-2:]) == ["uniform_noise", "mid_gray"]
    out = str(tmp_path / "calib.npz")
    tcalib.main(["--input_size", "64", "--image", photo, "--out", out])
    with np.load(out) as z:
        np.testing.assert_array_equal(z["frames"], frames)
    assert os.stat(committed).st_mtime_ns == before
    with pytest.raises(SystemExit):                  # --out is required
        tcalib.main(["--image", photo])
    with pytest.raises(SystemExit):                  # so is --image
        tcalib.main(["--out", out])


@pytest.fixture(scope="module")
def stand_ins(tmp_path_factory):
    """(MANO pickle dir, fp16 ``module.`` wild.pkl, smoke photo)."""
    import cv2
    d = tmp_path_factory.mktemp("stand_ins")
    write_mano_pkls(str(d / "mano"))
    ckpt = str(d / "wild.pkl")
    torch.save({"module." + k: torch.from_numpy(v).half()
                for k, v in tconv.stand_in_state_dict(seed=2).items()}, ckpt)
    photo = str(d / "photo.jpg")
    cv2.imwrite(photo, (np.random.RandomState(4).rand(96, 128, 3) * 255)
                .astype(np.uint8))
    return str(d / "mano"), ckpt, photo


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_ingest_cpu_end_to_end(tmp_path, stand_ins, capsys):
    mano_dir, ckpt, photo = stand_ins
    rc = tingest.main([
        "--mano_dir", mano_dir, "--checkpoint", ckpt,
        "--out_mano", str(tmp_path / "mano"),
        "--out_ckpt", str(tmp_path / "ckpt" / "wild.npz"),
        "--smoke_image", photo, "--smoke_output", str(tmp_path / "smoke") + "/",
        "--smoke_input_size", "64", "--device", "cpu"])
    report = capsys.readouterr().out
    assert rc == 0, report
    assert "converted 1050/1050 network params" in report
    assert "sha256" in report
    assert report.strip().splitlines()[-1] == \
        "DONE: real assets ingested and smoke-tested."
    assert os.path.exists(tmp_path / "smoke" / "photo.jpg")
    # the same npz files as JAX's ingest functions write
    assert jingest.ingest_mano(mano_dir, str(tmp_path / "jax_mano")) == 0
    assert jingest.ingest_checkpoint(ckpt, str(tmp_path / "jax.npz")) == 0
    for side in SIDES:
        assert_same_arrays(_npz(tmp_path / "mano" / f"mano_{side}.npz"),
                           _npz(tmp_path / "jax_mano" / f"mano_{side}.npz"))
    got = _npz(tmp_path / "ckpt" / "wild.npz")
    want = _npz(tmp_path / "jax.npz")
    assert list(got) == list(want)
    assert_same_arrays(got, want)


@pytest.mark.parametrize("named", [True, False],
                         ids=["absent_image", "no_image_given"])
def test_ingest_skips_a_missing_smoke_image(tmp_path, stand_ins, capsys,
                                            named):
    mano_dir, ckpt, _ = stand_ins
    image = ["--smoke_image", str(tmp_path / "absent.jpg")] if named else []
    rc = tingest.main([
        "--mano_dir", mano_dir, "--checkpoint", ckpt,
        "--out_mano", str(tmp_path / "mano"),
        "--out_ckpt", str(tmp_path / "wild.npz"),
        "--device", "cpu"] + image)
    report = capsys.readouterr().out
    assert rc == 0
    assert "SKIP: smoke image not found" in report
    assert report.strip().splitlines()[-1] == "DONE: real assets ingested."


def test_ingest_rejects_incomplete_checkpoint(tmp_path, stand_ins, capsys):
    mano_dir, _, _ = stand_ins
    bad = str(tmp_path / "partial.pkl")
    torch.save({"backbone.conv1.weight": torch.zeros(64, 3, 3, 3)}, bad)
    rc = tingest.main(["--mano_dir", mano_dir, "--checkpoint", bad,
                       "--out_mano", str(tmp_path / "m"),
                       "--out_ckpt", str(tmp_path / "c.npz"), "--no_smoke",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "MISSING" in out and not os.path.exists(tmp_path / "c.npz")


def test_ingest_missing_assets_fail_loudly(tmp_path, capsys):
    rc = tingest.main(["--mano_dir", str(tmp_path),
                       "--checkpoint", str(tmp_path / "nope.pkl"),
                       "--no_smoke", "--device", "cpu"])
    assert rc == 1
    out = capsys.readouterr().out
    assert "ERROR" in out and "not found" in out


def test_ingest_defaults_to_the_card(tmp_path, stand_ins):
    mano_dir, ckpt, _ = stand_ins
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tingest.main(["--mano_dir", mano_dir, "--checkpoint", ckpt,
                      "--out_mano", str(tmp_path / "m"),
                      "--out_ckpt", str(tmp_path / "c.npz")])
    assert not os.path.exists(tmp_path / "m")
