"""Visualization: on-device render, composite over the input, paste-back.

Counterpart of the image-path part of ``acr_tpu/viz/visualizer.py``
(reference: acr/visualization.py:18-300): alpha-blend the rendered mesh
over the network input (visible weight 0.9), then paste the square
render back into the original frame through the inverse of the pad/crop
offsets ('put_org', visualization.py:196-220), into a 4x frame above
1000 px of render. The render runs on the pipeline's device, or with
``renderer='native'`` on the host through the C++ z-buffer
(``io.native``, intrinsics camera only); compositing is host numpy + cv2. The auxiliary views of ``show_items`` (keypoints,
centre heat maps, the 3D skeleton) are host copies of the JAX package's,
held equal to them by ``tests/test_torch_port_aux.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from acr_tpu_torch.config import Config
from acr_tpu_torch.utils.device import resolve_device
from acr_tpu_torch.viz.raster import (
    PRE_COLORS,
    render_hands,
    render_overflow_probe,
)

# MANO 21-joint output order (models/mano.py REORDER_21): wrist, then
# thumb/index/middle/ring/pinky chains base->tip.
_FINGERS = ("thumb", "index", "middle", "ring", "pinky")
# InterHand drawing order maps fingertips first (reference:
# acr/visualization.py:25)
MANO2INTERHAND = np.array([4, 3, 2, 1, 8, 7, 6, 5, 12, 11, 10, 9,
                           16, 15, 14, 13, 20, 19, 18, 17, 0])


def hand_skeleton():
    """InterHand-style 21-joint skeleton: (name, parent_id) list.

    Chains of 4 per finger, tips at indices 4k, wrist last (the layout
    of the reference's mano/skeleton.txt, regenerated procedurally).
    """
    skeleton = []
    for f_idx, finger in enumerate(_FINGERS):
        for level in range(4):            # 4 = tip ... 1 = base
            joint_id = f_idx * 4 + level
            parent = joint_id + 1 if level < 3 else 20
            skeleton.append({"name": f"{finger}{4 - level}",
                             "parent_id": parent})
    skeleton.append({"name": "wrist", "parent_id": -1})
    return skeleton


_FINGER_RGB = {
    "thumb": (255, 0, 0), "index": (0, 255, 0), "middle": (255, 128, 0),
    "ring": (0, 128, 255), "pinky": (255, 0, 255), "wrist": (230, 230, 0),
}


def _joint_color(name: str):
    for finger, rgb in _FINGER_RGB.items():
        if name.startswith(finger):
            return rgb
    return (230, 230, 0)


class Visualizer:
    """Owns the MANO faces on the device (``cuda`` unless the caller asks
    for the CPU); composition in numpy."""

    def __init__(self, cfg: Config, faces: np.ndarray, device="cuda"):
        self.cfg = cfg
        self.faces = torch.as_tensor(faces.astype(np.int64),
                                     device=resolve_device(device))
        self.skeleton = hand_skeleton()
        # 'pt3d' mirrors the pytorch3d backend's rule: FoVPerspective when
        # perspective_proj else FoVOrthographic (renderer_pt3d.py:74-110)
        cm = cfg.camera_model
        if cm == "pt3d":
            cm = "fov" if cfg.perspective_proj else "ortho"
        self.camera = cm
        if cfg.renderer == "native" and cm != "intrinsics":
            raise ValueError(
                "the native C++ rasterizer implements the intrinsics "
                f"camera only; camera_model={cfg.camera_model!r} needs "
                "renderer='tpu'")

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

    def render_rgba(self, out: Dict, batch_idx: int = 0) -> np.ndarray:
        """Render both hands of one image -> (S, S, 4) float RGBA on the
        host: with ``renderer='native'`` the host C++ z-buffer
        (``io.native``), else the device render, read back."""
        if self.cfg.renderer == "native":
            return self._render_native(out, batch_idx)
        dev = self.faces.device
        verts, cam_trans, det, faces = self._render_args(out, batch_idx)
        return render_hands(torch.as_tensor(verts).to(dev),
                            torch.as_tensor(cam_trans).to(dev),
                            torch.as_tensor(det).to(dev), faces,
                            **self._render_kw()).cpu().numpy()

    def _render_native(self, out: Dict, batch_idx: int) -> np.ndarray:
        """The detected hands' meshes, each hand's faces offset past the
        vertices before it and coloured PRE_COLORS[hand], through the
        host z-buffer; zeros when no hand is detected."""
        from acr_tpu_torch.io.native import rasterize
        det = np.asarray(out["detection_flag"][batch_idx])
        verts = (np.asarray(out["verts"][batch_idx])
                 + np.asarray(out["cam_trans"][batch_idx])[:, None, :])
        faces_np = self.faces.cpu().numpy()
        all_verts, all_faces, all_colors = [], [], []
        offset = 0
        for hand in range(2):
            if not det[hand]:
                continue
            all_verts.append(verts[hand])
            all_faces.append(faces_np[hand] + offset)
            all_colors.append(np.tile(PRE_COLORS[hand], (faces_np.shape[1], 1)))
            offset += verts.shape[1]
        if not all_verts:
            return np.zeros((self.cfg.render_size, self.cfg.render_size, 4),
                            np.float32)
        return rasterize(np.concatenate(all_verts),
                         np.concatenate(all_faces),
                         np.concatenate(all_colors),
                         size=self.cfg.render_size,
                         focal=float(self.cfg.focal_length))

    def render_on_frame(self, bgr_frame: np.ndarray, out: Dict,
                        meta: Dict) -> np.ndarray:
        """Render (``render_rgba``), composite and paste back one frame's
        host outputs; returns BGR."""
        return self.compose_on_frame(self.render_rgba(out), bgr_frame, meta,
                                     planar=False)

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
        """'put_org': place the square render into the original frame.

        Above 1000 px of render the frame and all ten offsets are scaled
        by 4 first, so a 2048 px render lands in a 4x frame
        (reference: visualization.py:206-216)."""
        import cv2
        offsets = offsets.astype(np.int64)
        (ph, pw) = offsets[:2]
        ct, cr, cb, cl = offsets[2:6]
        pt, pr, pb, pl = offsets[6:10]
        org = frame_rgb.copy()
        ih, iw = org.shape[:2]
        if self.cfg.render_size > 1000:
            ih, iw, ph, pw = ih * 4, iw * 4, ph * 4, pw * 4
            ct, cr, cb, cl = ct * 4, cr * 4, cb * 4, cl * 4
            pt, pr, pb, pl = pt * 4, pr * 4, pb * 4, pl * 4
            org = cv2.resize(org, (iw, ih), interpolation=cv2.INTER_LINEAR)
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

    def draw_keypoints(self, image_rgb: np.ndarray, kp2d: np.ndarray,
                       line_width: int = 3, radius: int = 3) -> np.ndarray:
        """Draw one hand's 21 projected joints + bones (PIL, uint8 RGB)."""
        from PIL import Image, ImageDraw
        kps = kp2d[MANO2INTERHAND]
        img = Image.fromarray(image_rgb.astype(np.uint8))
        draw = ImageDraw.Draw(img)
        for i, joint in enumerate(self.skeleton):
            pid = joint["parent_id"]
            color = _joint_color(joint["name"])
            if pid != -1:
                parent_color = _joint_color(self.skeleton[pid]["name"])
                draw.line([tuple(kps[i]), tuple(kps[pid])],
                          fill=parent_color, width=line_width)
            draw.ellipse((kps[i][0] - radius, kps[i][1] - radius,
                          kps[i][0] + radius, kps[i][1] + radius), fill=color)
        return np.asarray(img)

    def aux_views(self, out: Dict, meta: Dict,
                  items: Sequence[str]) -> Dict[str, np.ndarray]:
        """Auxiliary visualizations per show_items (reference:
        acr/visualization.py:174-254 'org_img'/'pj2d'/'centermap'/'j3d').
        Returns {item_name: uint8 RGB image}."""
        views: Dict[str, np.ndarray] = {}
        input_rgb = np.asarray(meta["image"][0])
        det = np.asarray(out["detection_flag"])[0]
        for item in items:
            if item == "org_img":
                views["org_img"] = input_rgb
            elif item == "pj2d":
                img = input_rgb.copy()
                pj2d_px = (np.asarray(out["pj2d"])[0] + 1) / 2 * input_rgb.shape[0]
                for hand in range(2):
                    if det[hand]:
                        img = self.draw_keypoints(img, pj2d_px[hand])
                views["pj2d"] = np.asarray(img)
            elif item == "centermap" and "l_center_map" in out:
                l = self.make_heatmap_overlay(input_rgb,
                                              np.asarray(out["l_center_map"])[0])
                r = self.make_heatmap_overlay(input_rgb,
                                              np.asarray(out["r_center_map"])[0])
                views["centermap"] = np.concatenate([l, r], axis=1)
            elif item == "j3d":
                from acr_tpu_torch.viz.skeleton3d import Plotter3dPoses
                plotter = Plotter3dPoses(
                    canvas_size=input_rgb.shape[:2])
                poses = [np.asarray(out["j3d"])[0, h] for h in range(2)
                         if det[h]]
                colors = [(255, 0, 0), (0, 255, 255)]
                views["j3d"] = plotter.encircle_plot(poses, colors[:len(poses)])
        return views

    def make_heatmap_overlay(self, image_rgb: np.ndarray,
                             heatmap: np.ndarray) -> np.ndarray:
        """JET-colormap center-heatmap over the image (reference:
        acr/visualization.py:280-300)."""
        import cv2
        h = np.asarray(heatmap)
        if h.ndim == 3:
            h = h[..., 0]
        h = cv2.resize(h, image_rgb.shape[:2][::-1])
        h8 = np.clip(h * 255, 0, 255).astype(np.uint8)
        colored = cv2.applyColorMap(h8, cv2.COLORMAP_JET)[:, :, ::-1]
        return (colored * 0.7 + image_rgb * 0.3).astype(np.uint8)
