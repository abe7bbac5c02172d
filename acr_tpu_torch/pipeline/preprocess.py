"""Host-side frame preprocessing (numpy/cv2): pad-to-square + resize.

Mirrors the reference preprocessing semantics exactly — BGR->RGB flip,
white-background square padding, cubic uint8 resize to the network
input size, and the 10-number offsets record used to map predictions
back to original-image coordinates (reference: acr/utils.py:1276-1337).
The imgaug dependency is replaced with plain numpy padding that
reproduces ``imgaug.compute_paddings_to_reach_aspect_ratio``'s
floor/ceil split.

A copy of ``acr_tpu/pipeline/preprocess.py`` (the port imports nothing
of the JAX package); ``tests/test_torch_port_host.py`` holds it equal to
the original. One change: a frame already square at ``input_size`` skips
the cubic resize, which is an identity there, so the port's image path
needs neither cv2 nor PIL for such frames.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except Exception:                                   # pragma: no cover
    cv2 = None
    _HAS_CV2 = False


def compute_pad_trbl(shape: Tuple[int, ...], aspect_ratio: float = 1.0
                     ) -> Tuple[int, int, int, int]:
    """(top, right, bottom, left) padding to reach width/height ratio.

    Width deficit splits floor-left/ceil-right; height deficit splits
    floor-top/ceil-bottom (imgaug semantics the reference relies on).
    """
    h, w = shape[:2]
    pad_t = pad_r = pad_b = pad_l = 0
    current = w / h
    if current < aspect_ratio:          # too narrow: pad width
        diff = aspect_ratio * h - w
        pad_l = int(np.floor(diff / 2))
        pad_r = int(np.ceil(diff / 2))
    elif current > aspect_ratio:        # too wide: pad height
        diff = w / aspect_ratio - h
        pad_t = int(np.floor(diff / 2))
        pad_b = int(np.ceil(diff / 2))
    return pad_t, pad_r, pad_b, pad_l


def pad_white_square(image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pad to square with white background; return (padded, offsets[10]).

    offsets = [H_pad, W_pad, crop_trbl(4)=0, pad_trbl(4)]
    (reference: acr/utils.py:1303-1308).
    """
    pad_t, pad_r, pad_b, pad_l = compute_pad_trbl(image.shape)
    padded = np.pad(image, ((pad_t, pad_b), (pad_l, pad_r), (0, 0)),
                    constant_values=255)
    offsets = np.array([*padded.shape[:2], 0, 0, 0, 0,
                        pad_t, pad_r, pad_b, pad_l], np.float32)
    return padded, offsets


def resize_uint8_cubic(image: np.ndarray, size: int) -> np.ndarray:
    if _HAS_CV2:
        return cv2.resize(image, (size, size), interpolation=cv2.INTER_CUBIC)
    from PIL import Image                            # pragma: no cover
    return np.asarray(Image.fromarray(image).resize((size, size),
                                                    Image.BICUBIC))


def img_preprocess(bgr_frame: np.ndarray, imgpath: Optional[str] = None,
                   input_size: int = 512, single_img_input: bool = True
                   ) -> Dict[str, np.ndarray]:
    """BGR frame -> network input dict (uint8 BHWC image + offsets).

    Normalization happens inside the backbone, matching the reference
    (acr/model.py:832); this stays uint8 so the host->HBM transfer is
    3 bytes/pixel.
    """
    rgb = bgr_frame[:, :, ::-1]
    padded, offsets = pad_white_square(rgb)
    if padded.shape[:2] == (input_size, input_size):
        image = padded
    else:
        image = resize_uint8_cubic(padded, input_size)
    if single_img_input:
        image = image[None]
        offsets = offsets[None]
    out = {"image": np.ascontiguousarray(image), "offsets": offsets,
           "data_set": "internet"}
    if imgpath is not None:
        out["imgpath"] = imgpath
        out["name"] = imgpath.split("/")[-1]
    return out
