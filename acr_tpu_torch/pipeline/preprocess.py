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

``vitdet_preprocess`` is the port's own, the host half of ViTDet's input
(``detector='vitdet'``): the RGB frame as it is, which the device resizes
to fill an ``input_size`` square and pads at the bottom and right
(``pipeline.vitdet.resize_input``, detectron2's ``ResizeShortestEdge``
and ``square_pad``), and the offsets of that square in the frame.
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


def resized_shape(h: int, w: int, size: int) -> Tuple[int, int]:
    """detectron2's ``ResizeShortestEdge(size, max_size=size)``: the
    frame's (h, w) scaled so that its longer side is ``size``."""
    scale = size * 1.0 / min(h, w)
    newh, neww = (size * 1.0, scale * w) if h < w else (scale * h, size * 1.0)
    if max(newh, neww) > size:
        scale = size * 1.0 / max(newh, neww)
        newh, neww = newh * scale, neww * scale
    return int(newh + 0.5), int(neww + 0.5)


def vitdet_preprocess(bgr_frame: np.ndarray, imgpath: Optional[str] = None,
                      input_size: int = 1024) -> Dict[str, np.ndarray]:
    """BGR frame -> ViTDet's host input: the RGB frame (1, H, W, 3) uint8,
    and offsets (1, 10) whose square, the frame padded at the bottom and
    right to its longer side, the resized input fills."""
    h, w = bgr_frame.shape[:2]
    side = max(h, w)
    offsets = np.array([side, side, 0, 0, 0, 0, 0, side - w, side - h, 0],
                       np.float32)
    out = {"image": np.ascontiguousarray(bgr_frame[None, :, :, ::-1]),
           "offsets": offsets[None], "data_set": "internet"}
    if imgpath is not None:
        out["imgpath"] = imgpath
        out["name"] = imgpath.split("/")[-1]
    return out


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
