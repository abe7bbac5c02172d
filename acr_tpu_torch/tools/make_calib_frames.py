"""Build an int8 calibration set (the layout of model_data/calib).

Counterpart of ``tools/make_calib_frames.py``: a small real-frame set
derived from one photo (``--image``, required: a real two-hand image
such as the reference's ``demo/magic.jpg``) plus deterministic
photometric and geometric variants,
each pushed through the port's ``pipeline.preprocess.img_preprocess``,
the serving path's own, then the two synthetic structural bounds
(uniform noise + mid-gray) so activation ranges stay bounded even for
out-of-distribution inputs.

Output (``--out``, required: the tool never writes over the committed
``model_data/calib/calib_frames.npz`` unless ``--out`` names it):
  frames  (N, S, S, 3) uint8 — ready network inputs
  names   (N,) str — provenance per frame
  source  the photo's path
``ops.quant.committed_calibration_frames`` loads the committed set as
the default calibration of the int8 paths.

Usage:
  python -m acr_tpu_torch.tools.make_calib_frames --out calib.npz \\
      --image photo.jpg [--input_size 512]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def derive_variants(bgr: np.ndarray):
    """Deterministic variants covering both pad branches, both
    horizontal hand orders, scale and exposure shifts."""
    rng = np.random.RandomState(0)
    h, w = bgr.shape[:2]
    yield "magic", bgr
    yield "magic_flip", bgr[:, ::-1]
    yield "magic_wide", bgr[:, : int(w * 0.73)]          # pad-height branch
    tall = bgr[100:, 600:1100].astype(np.int16)
    tall = tall + (rng.randn(*tall.shape) * 3).astype(np.int16)
    yield "magic_tall_noise", np.clip(tall, 0, 255).astype(np.uint8)
    yield "magic_bright", np.clip(
        bgr.astype(np.int16) + 40, 0, 255).astype(np.uint8)
    yield "magic_dark", np.clip(
        bgr.astype(np.int16) - 40, 0, 255).astype(np.uint8)
    import cv2
    yield "magic_half", cv2.resize(bgr, (w // 2, h // 2),
                                   interpolation=cv2.INTER_AREA)


def build(input_size: int, image: str):
    """(frames (N, S, S, 3) uint8, names (N,)) from the photo at ``image``."""
    from acr_tpu_torch.pipeline.preprocess import img_preprocess

    import cv2
    bgr = cv2.imread(image)
    if bgr is None:
        raise FileNotFoundError(f"calibration photo missing or unreadable: "
                                f"{image}")

    frames, names = [], []
    for name, img in derive_variants(bgr):
        meta = img_preprocess(img, name, input_size=input_size)
        frames.append(np.asarray(meta["image"][0], np.uint8))
        names.append(name)
    # structural bounds (ops/quant.default_calibration_frames): keep
    # activation scales valid for inputs far outside the photo's
    # distribution
    r = np.random.RandomState(0)
    frames.append(r.randint(0, 255, (input_size, input_size, 3)
                            ).astype(np.uint8))
    names.append("uniform_noise")
    frames.append(np.full((input_size, input_size, 3), 127, np.uint8))
    names.append("mid_gray")
    return np.stack(frames), np.array(names)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--input_size", type=int, default=512)
    ap.add_argument("--image", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    frames, names = build(args.input_size, args.image)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, frames=frames, names=names,
                        source=args.image)
    print(f"wrote {args.out}: {frames.shape} uint8, "
          f"{os.path.getsize(args.out) / 1e6:.2f} MB, frames: "
          + ", ".join(names))


if __name__ == "__main__":
    main()
