"""Multi-view 3D skeleton plotting on a 3x3 canvas grid.

A copy of ``acr_tpu/viz/skeleton3d.py`` (the port imports nothing of the
JAX package); ``tests/test_torch_port_aux.py`` holds it equal to the
original. Counterpart of the reference's ``Plotter3dPoses`` (reference:
acr/visualization.py:441-506): orthographic projections of the 21-joint
skeleton from nine (theta, phi) viewpoints arranged in a 3x3 grid,
drawn with cv2 lines — no matplotlib.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

# bone list for the 21-joint MANO output order (wrist=0, then
# thumb/index/middle/ring/pinky chains base->tip at 1+4k..4+4k)
BONES_21 = [(0, 1 + 4 * f) for f in range(5)] + [
    (1 + 4 * f + k, 2 + 4 * f + k) for f in range(5) for k in range(3)]


def _rotation(theta: float, phi: float) -> np.ndarray:
    """(3, 2) orthographic view matrix (transposed, as the reference)."""
    sin, cos = math.sin, math.cos
    return np.array([
        [cos(theta), sin(theta) * sin(phi)],
        [-sin(theta), cos(theta) * sin(phi)],
        [0.0, -cos(phi)],
    ], np.float32)


class Plotter3dPoses:
    """Render pose skeletons from multiple viewpoints onto one canvas."""

    def __init__(self, canvas_size: Tuple[int, int] = (512, 512),
                 scale: float = 200.0):
        self.canvas_size = canvas_size
        self.scale = scale

    def _plot_edges(self, img, joints: np.ndarray, rot: np.ndarray,
                    origin: np.ndarray, color, scale: float):
        import cv2
        pts2d = joints @ rot * scale + origin
        for a, b in BONES_21:
            pa, pb = pts2d[a].astype(int), pts2d[b].astype(int)
            cv2.line(img, tuple(pa), tuple(pb), color, 2, cv2.LINE_AA)

    def plot(self, pose_3ds: Sequence[np.ndarray],
             colors: Optional[Sequence] = None,
             img: Optional[np.ndarray] = None,
             theta: float = 0.0, phi: float = math.pi / 2) -> np.ndarray:
        """Single-view plot."""
        h, w = self.canvas_size
        img = (np.full((h, w, 3), 255, np.uint8) if img is None else img)
        colors = colors or [(255, 0, 0)] * len(pose_3ds)
        rot = _rotation(theta, phi)
        origin = np.array([w / 2, h / 2], np.float32)
        for joints, color in zip(pose_3ds, colors):
            self._plot_edges(img, np.asarray(joints, np.float32), rot,
                             origin, color, self.scale)
        return img

    def encircle_plot(self, pose_3ds: Sequence[np.ndarray],
                      colors: Optional[Sequence] = None,
                      img: Optional[np.ndarray] = None) -> np.ndarray:
        """3x3 grid of viewpoints (theta in {0, pi/4, pi/2} x three phis)."""
        h, w = self.canvas_size
        img = (np.full((h, w, 3), 255, np.uint8) if img is None else img)
        colors = colors or [(255, 0, 0), (0, 255, 255)]
        thetas = [0, 0, 0, math.pi / 4, math.pi / 4, math.pi / 4,
                  math.pi / 2, math.pi / 2, math.pi / 2]
        phis = [math.pi / 2, 5 * math.pi / 7, -2 * math.pi / 7] * 3
        centers = np.array([[0.165, 0.165], [0.495, 0.165], [0.825, 0.165],
                            [0.165, 0.495], [0.495, 0.495], [0.825, 0.495],
                            [0.165, 0.825], [0.495, 0.825], [0.825, 0.825]],
                           np.float32) * np.array([w, h], np.float32)
        for theta, phi, origin in zip(thetas, phis, centers):
            rot = _rotation(theta, phi)
            for joints, color in zip(pose_3ds, colors):
                self._plot_edges(img, np.asarray(joints, np.float32) * 0.6,
                                 rot, origin, color, self.scale)
        return img
