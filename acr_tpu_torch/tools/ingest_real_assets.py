"""ONE-COMMAND ingestion of the real licensed assets, on the port.

Counterpart of ``tools/ingest_real_assets.py``. The reference needs two
license-gated downloads (reference: README.md:40-41): the MANO pickles
(``MANO_LEFT.pkl`` / ``MANO_RIGHT.pkl``, registered download) and the
pretrained checkpoint (``checkpoints/wild.pkl``, torch pickle —
acr/main.py:59). This tool turns "converter-run + demo-eyeball" into a
single command:

  python -m acr_tpu_torch.tools.ingest_real_assets \\
      --mano_dir /path/with/MANO_{LEFT,RIGHT}.pkl \\
      --checkpoint /path/to/wild.pkl [--device cpu]

which

1. converts both MANO pickles -> ``model_data/mano/mano_{side}.npz``
   (chumpy-free; left-hand shapedirs flip baked in —
   ``tools.convert_mano``), validating every tensor against the MANO
   shape contract;
2. converts the torch checkpoint -> ``checkpoints/wild.npz`` (BN folded,
   layouts transposed — ``tools.convert_checkpoint``), failing loudly if
   any network parameter is missing;
3. prints a per-tensor shape/dtype report plus converted / missing /
   unused counts, the sha256 of each source file (compare against
   the checksums of your downloads; upstream publishes none) and the
   host wall time of each step;
4. runs a golden smoke: image demo mode through the port's ``ACRApp``
   on ``--device`` (``cuda`` by default; it raises without a card unless
   ``--device cpu`` is given) on the photo ``--smoke_image`` names (the
   reference's ``demo/magic.jpg``, say), asserting an output render is
   written and every result tensor is finite. A smoke image that is not
   given or not found is reported as SKIP.

Exit code 0 = assets ingested (and, where the last line says so, smoke
tested); the npz files load in both packages.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time
from typing import Optional

import numpy as np

from acr_tpu_torch.config import _REPO_ROOT
from acr_tpu_torch.io.params import savez_atomic

# MANO tensor contract (reference: mano/manolayer.py:350-394; the
# runtime loader acr_tpu_torch/models/mano.py)
MANO_SHAPES = {
    "v_template": (778, 3),
    "shapedirs": (778, 3, 10),
    "posedirs": (778, 3, 135),
    "J_regressor": (16, 778),
    "weights": (778, 16),
    "faces": (1538, 3),
    "hands_mean": (45,),
    "hands_components": (45, 45),
    "kintree_table": (2, 16),
}


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def ingest_mano(mano_dir: str, out_dir: str) -> int:
    """Convert + validate both MANO pickles; returns #errors."""
    from acr_tpu_torch.tools.convert_mano import convert
    os.makedirs(out_dir, exist_ok=True)
    errors = 0
    for side, name in (("left", "MANO_LEFT.pkl"), ("right", "MANO_RIGHT.pkl")):
        src = os.path.join(mano_dir, name)
        if not os.path.exists(src):
            print(f"ERROR: {src} not found (register + download from "
                  "the MANO site; reference README.md:40)")
            errors += 1
            continue
        print(f"\n== {name} (sha256 {_sha256(src)[:16]}…) ==")
        out = convert(src, side)
        for key, want in MANO_SHAPES.items():
            got = tuple(out[key].shape)
            status = "ok" if got == want else f"EXPECTED {want}"
            if got != want:
                errors += 1
            print(f"  {key:18s} {str(got):16s} {out[key].dtype}  {status}")
        dst = os.path.join(out_dir, f"mano_{side}.npz")
        savez_atomic(dst, out)
        print(f"  -> {dst}")
    return errors


def ingest_checkpoint(ckpt_path: str, out_path: str,
                      allow_missing: bool = False) -> int:
    """Convert + validate the torch checkpoint; returns #errors."""
    from acr_tpu_torch.tools.convert_checkpoint import (
        _to_numpy_state_dict, carry_parser_heads, convert_state_dict,
        enumerate_flax_paths)
    if not os.path.exists(ckpt_path):
        print(f"ERROR: {ckpt_path} not found (download per reference "
              "README.md:41)")
        return 1
    print(f"\n== {os.path.basename(ckpt_path)} "
          f"(sha256 {_sha256(ckpt_path)[:16]}…) ==")
    torch_sd = _to_numpy_state_dict(ckpt_path)
    paths = enumerate_flax_paths()
    flat, used, missing = convert_state_dict(torch_sd, paths)
    carry_parser_heads(torch_sd, flat, used)
    unused = sorted(set(torch_sd) - used)
    print(f"  converted {len(flat)}/{len(paths)} network params "
          f"({len(missing)} missing, {len(unused)} torch keys unused)")
    for name in sorted(flat)[:8]:
        print(f"    {name:48s} {str(flat[name].shape):16s} "
              f"{flat[name].dtype}")
    if len(flat) > 8:
        print(f"    … {len(flat) - 8} more (full list in the npz)")
    if unused:
        print(f"  unused torch keys (expected: the dead "
              f"segmentation_layers head + ManoLayer buffers, "
              f"PARITY.md):", *unused[:6], sep="\n    ")
    errors = 0
    if missing:
        print(f"  MISSING ({len(missing)}):", *missing[:20], sep="\n    ")
        if not allow_missing:
            print("  ERROR: the checkpoint does not cover the network "
                  "(pass --allow_missing to write anyway)")
            errors += 1
    if not errors:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        savez_atomic(out_path, flat)
        print(f"  -> {out_path}")
    return errors


def golden_smoke(mano_dir: str, ckpt_path: str, image: Optional[str],
                 output_dir: str, input_size: int = 512,
                 device="cuda") -> int:
    """Image-mode end-to-end on the converted assets, on ``device``;
    returns #errors (0 with a SKIP line when ``image`` is None or
    absent)."""
    print(f"\n== golden smoke: image mode on {image} ==")
    if image is None or not os.path.exists(image):
        print("  SKIP: smoke image not found")
        return 0
    from acr_tpu_torch.config import Config
    from acr_tpu_torch.pipeline.app import ACRApp
    cfg = Config(demo_mode="image", inputs=image, output_dir=output_dir,
                 mano_model_path=mano_dir, model_path=ckpt_path,
                 save_dict_results=True, input_size=input_size)
    app = ACRApp(cfg, device=device)
    results = app.run()
    errors = 0
    out_img = os.path.join(output_dir, os.path.basename(image))
    if not os.path.exists(out_img):
        print(f"  ERROR: no output render at {out_img}")
        errors += 1
    hands = sum(len(h) for h in results.values())
    for path, hand_list in results.items():
        for h in hand_list:
            for key, val in h.items():
                if isinstance(val, np.ndarray) and \
                        not np.isfinite(np.float32(val)).all():
                    print(f"  ERROR: non-finite {key} for {path}")
                    errors += 1
    print(f"  detected {hands} hand(s) on {app.pipeline.device}; render + "
          f"results written to {output_dir}" if not errors
          else "  smoke FAILED")
    return errors


def _timed(step, *args, **kwargs) -> int:
    """``step(*args, **kwargs)``, then a line with its host wall time."""
    t0 = time.perf_counter()
    errors = step(*args, **kwargs)
    print(f"  [{step.__name__}: {time.perf_counter() - t0:.3f} s host wall]")
    return errors


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="One-command real-asset ingestion (MANO pkls + "
                    "wild.pkl -> npz) with validation + golden smoke")
    ap.add_argument("--mano_dir", required=True,
                    help="directory containing MANO_LEFT.pkl / MANO_RIGHT.pkl")
    ap.add_argument("--checkpoint", required=True,
                    help="path to the pretrained wild.pkl")
    ap.add_argument("--out_mano",
                    default=os.path.join(_REPO_ROOT, "model_data", "mano"))
    ap.add_argument("--out_ckpt",
                    default=os.path.join(_REPO_ROOT, "checkpoints", "wild.npz"))
    ap.add_argument("--smoke_image", default=None,
                    help="the photo of the smoke run (skipped without it)")
    ap.add_argument("--smoke_output", default="./demos_outputs/ingest_smoke/")
    ap.add_argument("--smoke_input_size", type=int, default=512)
    ap.add_argument("--no_smoke", action="store_true")
    ap.add_argument("--allow_missing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the smoke (cuda unless 'cpu')")
    args = ap.parse_args(argv)

    from acr_tpu_torch.utils.device import resolve_device
    resolve_device(args.device)       # no card: raise before converting
    errors = _timed(ingest_mano, args.mano_dir, args.out_mano)
    errors += _timed(ingest_checkpoint, args.checkpoint, args.out_ckpt,
                     allow_missing=args.allow_missing)
    if errors:
        print(f"\nFAILED: {errors} error(s) before smoke; fix and re-run")
        return 1
    smoked = False
    if not args.no_smoke:
        errors += _timed(golden_smoke, args.out_mano, args.out_ckpt,
                         args.smoke_image, args.smoke_output,
                         input_size=args.smoke_input_size,
                         device=args.device)
        smoked = errors == 0 and args.smoke_image is not None and \
            os.path.exists(args.smoke_image)
    if errors:
        print(f"\nFAILED: {errors} smoke error(s)")
        return 1
    print("\nDONE: real assets ingested"
          + (" and smoke-tested." if smoked else "."))
    return 0


if __name__ == "__main__":
    sys.exit(main())
