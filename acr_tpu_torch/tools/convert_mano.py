"""Convert MANO pickle assets (MANO_LEFT.pkl / MANO_RIGHT.pkl) to plain npz.

The port's copy of ``tools/convert_mano.py``: the same arrays, bit for
bit, which both packages load (``acr_tpu_torch.models.mano``).

The reference deserializes MANO pickles through chumpy at model-build
time on every run (reference: mano/manolayer.py:350-394). We instead
convert once, offline, to an npz of plain numpy arrays; the runtime
MANO layer (acr_tpu_torch/models/mano.py) has no pickle/chumpy
dependency.

chumpy is not required: a stub unpickler extracts the underlying
ndarray from chumpy objects (their pickled state carries the data in
'x'); scipy sparse matrices (J_regressor) are densified.

The left-hand shapedirs x-flip applied by the reference at runtime
(acr/mano_wrapper.py:35) is baked in at convert time for side='left'.

Usage:
  python -m acr_tpu_torch.tools.convert_mano \
      --mano_dir <dir with MANO_{LEFT,RIGHT}.pkl> --out_dir model_data/mano
"""

from __future__ import annotations

import argparse
import io
import os
import pickle
import sys

import numpy as np

from acr_tpu_torch.io.params import savez_atomic


class _ChumpyStub:
    """Placeholder for chumpy objects; captures pickled state."""

    def __init__(self, *a, **kw):
        self.__dict__["_state"] = {}

    def __setstate__(self, state):
        self.__dict__["_state"] = state


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyStub
        return super().find_class(module, name)


def _to_array(obj):
    """Best-effort extraction of a plain ndarray from a pickled value."""
    if isinstance(obj, np.ndarray):
        return obj
    if isinstance(obj, _ChumpyStub):
        state = obj.__dict__.get("_state", {})
        if isinstance(state, dict):
            for key in ("x", "a", "_data"):
                if key in state:
                    return _to_array(state[key])
        raise ValueError("could not extract array from chumpy stub: "
                         f"state keys={list(state) if isinstance(state, dict) else type(state)}")
    if hasattr(obj, "toarray"):  # scipy sparse
        return np.asarray(obj.toarray())
    return np.asarray(obj)


def load_mano_pkl(path: str) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    return _StubUnpickler(io.BytesIO(data), encoding="latin1").load()


def convert(pkl_path: str, side: str) -> dict:
    dd = load_mano_pkl(pkl_path)
    out = {
        "v_template": _to_array(dd["v_template"]).astype(np.float32),      # (778, 3)
        "shapedirs": _to_array(dd["shapedirs"]).astype(np.float32),        # (778, 3, 10)
        "posedirs": _to_array(dd["posedirs"]).astype(np.float32),          # (778, 3, 135)
        "J_regressor": _to_array(dd["J_regressor"]).astype(np.float32),    # (16, 778) dense
        "weights": _to_array(dd["weights"]).astype(np.float32),            # (778, 16)
        "faces": _to_array(dd["f"]).astype(np.int32),                      # (1538, 3)
        "hands_mean": _to_array(dd["hands_mean"]).astype(np.float32),      # (45,)
        "hands_components": _to_array(dd["hands_components"]).astype(np.float32),
        "kintree_table": _to_array(dd["kintree_table"]).astype(np.int64),  # (2, 16)
    }
    if side == "left":
        # reference applies this at runtime (acr/mano_wrapper.py:35)
        out["shapedirs"] = out["shapedirs"].copy()
        out["shapedirs"][:, 0, :] *= -1
    out["side"] = np.array(side)
    return out


def reference_layout(assets: dict) -> dict:
    """The MANO download's dict (float64, a sparse ``J_regressor``, the
    raw key names, uint32 ``f``; reference: mano/manolayer.py:350-394)
    from converted assets, with the left hand's shapedirs flip taken
    back out: the stand-in that ``convert`` turns back into ``assets``."""
    import scipy.sparse as sp
    shapedirs = np.asarray(assets["shapedirs"], np.float64).copy()
    if str(assets.get("side", "right")) == "left":
        shapedirs[:, 0, :] *= -1
    return {
        "v_template": np.asarray(assets["v_template"], np.float64),
        "shapedirs": shapedirs,
        "posedirs": np.asarray(assets["posedirs"], np.float64),
        "J_regressor": sp.csc_matrix(
            np.asarray(assets["J_regressor"], np.float64)),
        "weights": np.asarray(assets["weights"], np.float64),
        "f": np.asarray(assets["faces"]).astype(np.uint32),
        "hands_mean": np.asarray(assets["hands_mean"], np.float64),
        "hands_components": np.asarray(assets["hands_components"],
                                       np.float64),
        "kintree_table": np.asarray(assets["kintree_table"]),
        "bs_type": "lrotmin",
        "bs_style": "lbs",
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mano_dir", required=True)
    ap.add_argument("--out_dir", default="model_data/mano")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for side, name in (("left", "MANO_LEFT.pkl"), ("right", "MANO_RIGHT.pkl")):
        src = os.path.join(args.mano_dir, name)
        if not os.path.exists(src):
            print(f"skip {side}: {src} not found", file=sys.stderr)
            continue
        out = convert(src, side)
        dst = os.path.join(args.out_dir, f"mano_{side}.npz")
        savez_atomic(dst, out)
        print(f"wrote {dst}")


if __name__ == "__main__":
    main()
