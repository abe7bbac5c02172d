"""Frame capture: latency-optimized producer thread + simple capture.

Copies of ``acr_tpu/pipeline/capture.py`` (cv2 imported on first use).
The webcam path keeps the reference's frame-dropping producer pattern
(reference: acr/utils.py:1359-1391): a thread continuously grabs frames
and ``read()`` returns the newest one, so inference never queues behind
stale frames. Reference assignment is GIL-atomic; dropping is by design.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np


class OpenCVCapture:
    """Sequential capture from a camera id or video file."""

    def __init__(self, video_file: Optional[str] = None, cam_id: int = 0):
        import cv2
        self.cap = cv2.VideoCapture(cam_id if video_file is None else video_file)
        self.length = (int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
                       if video_file else -1)

    def read(self) -> Optional[np.ndarray]:
        ok, frame = self.cap.read()
        return frame if ok else None

    def release(self):
        self.cap.release()


class WebcamVideoStream:
    """Producer thread grabbing frames forever; read() = latest frame."""

    def __init__(self, src: int = 0):
        import cv2
        self.stream = cv2.VideoCapture(src)
        if not self.stream.isOpened():
            self.stream = cv2.VideoCapture(f"/dev/video{src}", cv2.CAP_V4L2)
        if not self.stream.isOpened():
            raise RuntimeError(f"could not open camera {src}")
        self.grabbed, self.frame = self.stream.read()
        self.stopped = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "WebcamVideoStream":
        self._thread = threading.Thread(target=self._update, daemon=True)
        self._thread.start()
        return self

    def _update(self):
        import time
        while not self.stopped:
            self.grabbed, frame = self.stream.read()
            if self.grabbed:
                self.frame = frame
            else:
                time.sleep(0.01)       # dead/stalled device: don't spin hot

    def read(self) -> np.ndarray:
        return self.frame

    def stop(self):
        self.stopped = True
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        self.stream.release()
