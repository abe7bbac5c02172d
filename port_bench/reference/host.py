"""The demo's host image steps: the frame padded to a square with white
(floor and ceil halves), resized by cubic interpolation to the network
input, and the render blended over the input (0.9 of the mesh where it
covers) and pasted back into the original frame through the padding."""

from __future__ import annotations

import cv2
import numpy as np


def preprocess(bgr: np.ndarray, size: int):
    """BGR frame -> (uint8 (S, S, 3) RGB input, offsets (10,) float32)."""
    rgb = bgr[:, :, ::-1]
    h, w = rgb.shape[:2]
    pt = pb = pl = pr = 0
    if w > h:
        pt, pb = (w - h) // 2, (w - h) - (w - h) // 2
    elif h > w:
        pl, pr = (h - w) // 2, (h - w) - (h - w) // 2
    padded = np.pad(rgb, ((pt, pb), (pl, pr), (0, 0)), constant_values=255)
    offsets = np.array([padded.shape[0], padded.shape[1], 0, 0, 0, 0,
                        pt, pr, pb, pl], np.float32)
    if padded.shape[:2] != (size, size):
        padded = cv2.resize(padded, (size, size),
                            interpolation=cv2.INTER_CUBIC)
    return np.ascontiguousarray(padded), offsets


def composite(rgba: np.ndarray, input_rgb: np.ndarray, bgr: np.ndarray,
              offsets: np.ndarray) -> np.ndarray:
    """(S, S, 4) render, the network input, the original BGR frame and
    its offsets -> the delivered BGR frame."""
    s = rgba.shape[0]
    if input_rgb.shape[0] != s:
        input_rgb = cv2.resize(input_rgb, (s, s),
                               interpolation=cv2.INTER_LINEAR)
    cover = (rgba[..., 3:] > 0).astype(np.float32)
    mesh = rgba[..., :3] * 255.0
    blend = (mesh * cover * 0.9 + input_rgb * cover * 0.1
             + (1 - cover) * input_rgb).astype(np.uint8)
    ph, pw = int(offsets[0]), int(offsets[1])
    pt, pr, pb, pl = (int(x) for x in offsets[6:10])
    out = bgr[:, :, ::-1].copy()
    big = cv2.resize(blend, (pw + 1, ph + 1), interpolation=cv2.INTER_CUBIC)
    out[:, :] = big[pt:ph - pb, pl:pw - pr]
    return out[:, :, ::-1]
