"""Seeded camera-like frames and the paced camera.

A frame is a smooth colour field (a coarse random grid, cubic-upsampled)
that drifts from frame to frame, with a soft vignette and a little
sensor noise: the low-frequency content of a photo, not noise. The same
seed gives the same frames.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Deque, List, NamedTuple, Optional

import cv2
import numpy as np


def smooth_frames(seed, n: int, height: int, width: int, device="cpu",
                  grid: int = 6, noise: float = 2.0) -> List[np.ndarray]:
    """``n`` uint8 BGR frames of a slowly moving smooth scene, made on
    ``device`` from ``seed`` (an int, or a list of ints) in a few large
    calls."""
    import torch
    import torch.nn.functional as Fn
    if isinstance(seed, (list, tuple)):
        seed = int(np.random.SeedSequence(list(seed)).generate_state(1, np.uint64)[0])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    gh, gw = grid, max(2, round(grid * width / height))
    keys = torch.rand((n // 8 + 2, 3, gh, gw), generator=gen, device=device) * 215 + 20
    t = torch.arange(n, device=device)
    a = (t % 8).float()[:, None, None, None] / 8
    coarse = keys[t // 8] * (1 - a) + keys[t // 8 + 1] * a
    yy = (torch.arange(height, device=device).float()[:, None] / height - 0.5) ** 2
    xx = (torch.arange(width, device=device).float()[None, :] / width - 0.5) ** 2
    vignette = 1.0 - 0.25 * (yy + xx) / 0.5
    frames = []
    for c0 in range(0, n, 16):
        field = Fn.interpolate(coarse[c0:c0 + 16], size=(height, width),
                               mode="bicubic", align_corners=False)
        field = field * vignette + noise * torch.randn(
            field.shape, generator=gen, device=device)
        u8 = field.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
        frames.extend(np.ascontiguousarray(f) for f in u8)
    return frames


def write_clip(frames: List[np.ndarray], folder: str, quality: int) -> int:
    """The frames as ``000000.jpg``... in ``folder``; returns the bytes."""
    os.makedirs(folder, exist_ok=True)
    total = 0
    for i, f in enumerate(frames):
        ok, buf = cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, quality])
        if not ok:
            raise RuntimeError("JPEG encoding failed")
        with open(os.path.join(folder, f"{i:06d}.jpg"), "wb") as fh:
            fh.write(buf.tobytes())
        total += len(buf)
    return total


class Capture(NamedTuple):
    index: int          # frame number on the camera clock
    frame_id: int       # index into the frame pool
    captured: float     # capture time, time.perf_counter() seconds


class PacedCamera:
    """A camera that captures ``fps`` frames a second from ``t0`` until
    ``deadline``. ``read`` returns the newest captured frame and never the
    same frame twice: it waits for the next capture when the newest was
    already read, and frames the reader was too slow for are dropped (the
    latest-frame rule of a threaded webcam reader). Every frame read is
    queued in ``pending`` for its delivery to be matched."""

    def __init__(self, pool: List[np.ndarray], fps: float, t0: float,
                 deadline: float):
        self.pool, self.fps, self.t0, self.deadline = pool, fps, t0, deadline
        self.last = -1
        self.pending: Deque[Capture] = collections.deque()
        self.reads: List[Capture] = []

    def read(self) -> Optional[np.ndarray]:
        now = time.perf_counter()
        k = int((now - self.t0) * self.fps)
        if k <= self.last:
            k = self.last + 1
            wait = self.t0 + k / self.fps - now
            if wait > 0:
                time.sleep(wait)
        captured = self.t0 + k / self.fps
        if captured >= self.deadline:
            return None
        self.last = k
        cap = Capture(k, k % len(self.pool), captured)
        self.pending.append(cap)
        self.reads.append(cap)
        return self.pool[cap.frame_id]


class ListSource:
    """Frames of the pool in a fixed order, unpaced (the warm-up)."""

    def __init__(self, pool: List[np.ndarray], ids: List[int]):
        self.pool, self.ids = pool, list(ids)
        self.pending: Deque[Capture] = collections.deque()

    def read(self) -> Optional[np.ndarray]:
        if not self.ids:
            return None
        i = self.ids.pop(0)
        self.pending.append(Capture(-1, i, time.perf_counter()))
        return self.pool[i]
