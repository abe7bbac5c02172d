"""The image-mode application: one frame through the whole stack.

Counterpart of the image path of ``acr_tpu/pipeline/app.py``
(reference: acr/main.py:24-205): host preprocessing, the device step
(network, parser, MANO, projection, render), ONE readback, then the
host composite and the written frame. The device step issues work
without reading it back, apart from the render's tier choice
(``viz.raster.select_tier``); the readback is one
``torch.cuda.synchronize()`` and then ``.cpu()`` of the output dict.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from acr_tpu_torch.config import Config
from acr_tpu_torch.io.writers import save_results
from acr_tpu_torch.pipeline.infer import ACRPipeline
from acr_tpu_torch.pipeline.preprocess import img_preprocess
from acr_tpu_torch.pipeline.results import reorganize_results

log = logging.getLogger("acr_tpu_torch")


def readback(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One synchronisation, then every output to host numpy."""
    if any(v.is_cuda for v in out.values()):
        torch.cuda.synchronize()
    return {k: v.cpu().numpy() for k, v in out.items()}


class ACRApp:
    """Owns the pipeline, the visualizer and the output directory."""

    def __init__(self, cfg: Config, params=None, device="cpu",
                 merge_params=None):
        self.cfg = cfg
        self.pipeline = ACRPipeline(cfg, params=params, device=device,
                                    merge_params=merge_params)
        self.visualizer = None
        if cfg.save_visualization_on_img and cfg.renderer != "none":
            from acr_tpu_torch.viz.visualizer import Visualizer
            self.visualizer = Visualizer(cfg, self.pipeline.faces,
                                         device=self.pipeline.device)
        self.output_dir = cfg.output_dir or "./demos_outputs/"
        self._frame_idx = 0
        self.last_output: Optional[Dict[str, np.ndarray]] = None
        self._name_map: Dict[str, str] = {}
        self._used_names: set = set()

    def device_step(self, meta: Dict) -> Dict[str, np.ndarray]:
        """Forward + render (+ capacity probe every
        ``raster_overflow_every`` frames) on the device, then one readback.
        The planar (4, S, S) RGBA rides under ``_rgba``."""
        with torch.no_grad():
            out = self.pipeline(meta["image"], meta["offsets"])
            if self.visualizer is not None:
                out["_rgba"] = self.visualizer.render_rgba_device(out)
                every = self.cfg.raster_overflow_every
                if every and self._frame_idx % every == 0:
                    out["_raster_overflow"] = \
                        self.visualizer.overflow_probe_device(out)
        self._frame_idx += 1
        return readback(out)

    def process_frame(self, bgr_frame: np.ndarray, path: str
                      ) -> Dict[str, list]:
        """Full per-frame stack; returns the reference-format results dict."""
        meta = img_preprocess(bgr_frame, path, input_size=self.cfg.input_size)
        out = self.device_step(meta)
        self.last_output = out              # the frame's host outputs
        overflow = out.pop("_raster_overflow", None)
        if overflow is not None:
            self._log_overflow(*[int(x) for x in overflow.reshape(-1)])

        if not out["detection_flag"].any():
            log.info("no hand detected: %s", path)
            self._emit_frame(bgr_frame, path)
            return {path: []}

        results = reorganize_results(out, [path])
        if self.visualizer is not None:
            rendered = self.visualizer.compose_on_frame(
                out["_rgba"], bgr_frame, meta, planar=True)
            self._emit_frame(rendered, path)
        else:
            self._emit_frame(bgr_frame, path)
        return results

    def _log_overflow(self, max_tile: int, n_over: int,
                      max_band: int = 0, n_band_over: int = 0):
        if n_over:
            log.warning(
                "binned rasterizer overflow: %d tiles above capacity "
                "(max %d faces/tile) at render_size=%d — the frame was "
                "rendered by the exact flat kernel", n_over, max_tile,
                self.cfg.render_size)
        else:
            log.debug("raster capacity probe: max %d faces/tile, "
                      "max %d faces/band, 0 overflows", max_tile, max_band)

    def _emit_frame(self, bgr_frame: np.ndarray, path: str):
        if not self.cfg.save_visualization_on_img:
            return
        import cv2
        os.makedirs(self.output_dir, exist_ok=True)
        cv2.imwrite(os.path.join(self.output_dir, self._output_name(path)),
                    bgr_frame)

    def _output_name(self, path: str) -> str:
        """Unique output filename per input path (same-named inputs from
        different directories get a suffix instead of overwriting)."""
        if path in self._name_map:
            return self._name_map[path]
        base = os.path.basename(path)
        name, k = base, 1
        stem, ext = os.path.splitext(base)
        while name in self._used_names:
            name = f"{stem}_{k}{ext}"
            k += 1
        self._name_map[path] = name
        self._used_names.add(name)
        return name

    def run_image(self) -> Dict:
        imgpath = self.cfg.inputs
        if not imgpath or not os.path.exists(imgpath):
            raise FileNotFoundError(f"--inputs image not found: {imgpath}")
        self.output_dir = self.cfg.output_dir or \
            "./demos_outputs/single_images_output/"
        import cv2
        image = cv2.imread(imgpath)
        if image is None:
            raise ValueError(f"could not decode image: {imgpath}")
        results = self.process_frame(image, imgpath)
        if self.cfg.save_dict_results:
            save_results(imgpath, self.output_dir, results)
        return results

    def run(self) -> Optional[Dict]:
        if self.cfg.demo_mode != "image":
            raise NotImplementedError(
                f"demo_mode={self.cfg.demo_mode!r}: ROADMAP A9")
        return self.run_image()
