"""Visualization: on-device render, composite over the input, paste-back.

Counterpart of the image-path part of ``acr_tpu/viz/visualizer.py``
(reference: acr/visualization.py:18-300): alpha-blend the rendered mesh
over the network input (visible weight 0.9), then paste the square
render back into the original frame through the inverse of the pad/crop
offsets ('put_org', visualization.py:196-220). The render runs on the
pipeline's device; compositing is host numpy + cv2.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from acr_tpu_torch.config import Config
from acr_tpu_torch.viz.raster import render_hands, render_overflow_probe


class Visualizer:
    """Owns the MANO faces on the device; composition in numpy."""

    def __init__(self, cfg: Config, faces: np.ndarray, device="cpu"):
        self.cfg = cfg
        self.faces = torch.as_tensor(faces.astype(np.int64), device=device)
        # 'pt3d' mirrors the pytorch3d backend's rule: FoVPerspective when
        # perspective_proj else FoVOrthographic (renderer_pt3d.py:74-110)
        cm = cfg.camera_model
        if cm == "pt3d":
            cm = "fov" if cfg.perspective_proj else "ortho"
        self.camera = cm

    def _render_args(self, out: Dict, batch_idx: int):
        return (out["verts"][batch_idx], out["cam_trans"][batch_idx],
                out["detection_flag"][batch_idx], self.faces)

    def _render_kw(self):
        return dict(size=self.cfg.render_size,
                    focal=float(self.cfg.focal_length),
                    camera=self.camera, fov_deg=float(self.cfg.FOV))

    def render_rgba_device(self, out: Dict, batch_idx: int = 0) -> torch.Tensor:
        """Render one image's hands on the outputs' device -> planar
        (4, S, S) RGBA, without a readback."""
        return render_hands(*self._render_args(out, batch_idx),
                            planar=True, **self._render_kw())

    def overflow_probe_device(self, out: Dict, batch_idx: int = 0) -> torch.Tensor:
        """The (4,) int32 capacity probe (raster.render_overflow_probe)."""
        return render_overflow_probe(*self._render_args(out, batch_idx),
                                     **self._render_kw())

    def composite(self, rgba: np.ndarray, input_rgb: np.ndarray) -> np.ndarray:
        """Blend render over the (resized) network input; uint8 RGB."""
        s = rgba.shape[0]
        if input_rgb.shape[0] != s:
            import cv2
            input_rgb = cv2.resize(input_rgb, (s, s),
                                   interpolation=cv2.INTER_LINEAR)
        render = rgba[..., :3] * 255.0
        alpha = (rgba[..., 3:] > 0).astype(np.float32)
        blended = (render * alpha * 0.9 + input_rgb * alpha * 0.1
                   + (1 - alpha) * input_rgb)
        return blended.astype(np.uint8)

    def paste_back(self, rendered: np.ndarray, frame_rgb: np.ndarray,
                   offsets: np.ndarray) -> np.ndarray:
        """'put_org': place the square render into the original frame."""
        import cv2
        offsets = offsets.astype(np.int64)
        (ph, pw) = offsets[:2]
        ct, cr, cb, cl = offsets[2:6]
        pt, pr, pb, pl = offsets[6:10]
        org = frame_rgb.copy()
        ih, iw = org.shape[:2]
        resized = cv2.resize(rendered, (int(pw) + 1, int(ph) + 1),
                             interpolation=cv2.INTER_CUBIC)
        org[ct:ih - cb, cl:iw - cr] = resized[pt:ph - pb, pl:pw - pr]
        return org

    def compose_on_frame(self, rgba: np.ndarray, bgr_frame: np.ndarray,
                         meta: Dict, planar: Optional[bool] = None) -> np.ndarray:
        """Host compositing + paste-back of an (S, S, 4) or planar
        (4, S, S) RGBA; returns BGR."""
        rgba = np.asarray(rgba)
        if planar is None:
            planar = (rgba.ndim == 3 and rgba.shape[0] == 4
                      and rgba.shape[-1] != 4)
        if planar:
            rgba = np.moveaxis(rgba, 0, -1)
        blended = self.composite(rgba, np.asarray(meta["image"][0]))
        pasted = self.paste_back(blended, bgr_frame[:, :, ::-1],
                                 meta["offsets"][0])
        return pasted[:, :, ::-1]
