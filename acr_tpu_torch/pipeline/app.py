"""The application: one frame through the whole stack, and the four demo modes.

Counterpart of ``acr_tpu/pipeline/app.py`` (reference: acr/main.py:24-205):
host preprocessing, the device step (network, parser, MANO, projection,
OneEuro smoothing and MANO refine with ``-t``, render), ONE readback,
then the host composite and the written or shown frame. The device step
issues work without reading it back, apart from the banded render's
gate at 1024 px and above (``viz.raster.banded_fits``). On a card the
stream step ends by enqueueing its outputs' copies to pinned host memory
and an event after them, and ``unpack_stream`` waits for that event
alone, so reading frame k-1 back never waits for frame k's device work;
image mode, the chunks and the tools read back through ``readback``, one
``torch.cuda.synchronize()`` and then ``.cpu()`` of the output dict.

One step body, ``_step``, serves every batch: the stream and image
mode's single frame and the throughput path's chunks. The OneEuro state
(``filter_state``) is a tree of tensors on the pipeline's device,
carried from frame to frame and chunk to chunk. At batch 1 on a card
without a mesh each stage replays a CUDA graph (``pipeline.graphs``):
the forward's inside ``ACRPipeline``, and here OneEuro with the tail
and, below 1024 px, the render; the frame's image and offsets are staged
once, at the front of the step (``graphs.Inputs``), and the step waits
for nothing on the host. The smooth graph keeps the OneEuro state in
static tensors and advances it in place.

With ``detector='vitdet'`` the pipeline is ``pipeline.vitdet
.ViTDetPipeline`` (ViTDet-H, ViTPose-H and the hand keypoints, in
``issue.detect``, a CUDA graph ``StepGraph("detect")`` at batch 1) in
ACR's place, called as ACR's is; the frame is preprocessed for it
(``preprocess.vitdet_preprocess``) and each readback adds its counts to
``vitdet.DETECT``.

With ``architecture='hamer'`` the pipeline is the detector and
``regressor`` (``pipeline.hamer.Regressor``) runs HaMeR on its hands, a
stage of its own between the forward and OneEuro (``issue.regress``, a
fourth CUDA graph at batch 1) that ends in HaMeR's MANO and camera
tail; OneEuro then filters HaMeR's poses and betas, and the tail runs
again on them. The app installs the regressor's tail as the pipeline's
(``ACRPipeline.tail``), so every mesh tail of a step, either
architecture's, is a call of ``self.pipeline.refine``. The weights dict
carries HaMeR's tensors under ``hamer.`` beside ACR's; without them
HaMeR serves seeded stand-ins.

Folder and video mode at ``val_batch_size > 1`` take the throughput
path, ``_run_batched``: a producer thread decodes and preprocesses the
next chunk of frames while the device runs ``chunk_step`` on the current
one, then one readback per chunk.

The auxiliary ``show_items`` (org_img, pj2d, centermap, j3d) are written
beside each rendered frame in image, folder and video mode, as
``<stem>_<item><ext>`` (``_aux_path``); ``centermap`` has the forward
return its centre maps in fp32 (``return_maps``), the chunk step's
included. The webcam stream shows the mesh only, as in JAX.

The host paths of the native library (``io.native``): with
``renderer='native'`` the frames are drawn on the host after the
readback, and with ``jit_translation_solve=False`` the host RANSAC solve
replaces ``cam_trans`` after it. The chunk step then runs without its
render (JAX's per-stage path, whose reason is logged) and the frames
are rendered one by one after the solve. The app raises at construction
when either was asked for and the library cannot be built or loaded.

Under ``data_parallel > 1`` (``parallel.mesh``) the chunk step runs
sharded when its frames are independent: each replica runs the forward
and the per-frame render of its shard, the outputs are gathered and the
capacity probe is reduced over the whole chunk. With ``-t`` (the OneEuro
filter runs in frame order) or a ``val_batch_size`` that does not divide
over the mesh it takes JAX's per-stage path, with the reason in
``_fused_bypass_reason``: the forward runs sharded, then OneEuro, the
refine and the render run on the lead replica, where the filter state
lives. The stream step's forward is sharded the same way (its one frame
padded over the mesh). Every process holds every output; only rank 0
writes files.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from acr_tpu_torch.config import Config
from acr_tpu_torch.io.writers import (
    collect_image_list,
    save_results,
    save_video,
    split_frame,
)
from acr_tpu_torch.pipeline import graphs, hamer
from acr_tpu_torch.pipeline.infer import ACRPipeline
from acr_tpu_torch.pipeline.results import reorganize_results
from acr_tpu_torch.pipeline.temporal import init_two_hand_filter, smooth_sequence
from acr_tpu_torch.utils.meters import SpanTimer

log = logging.getLogger("acr_tpu_torch")

# the stream steps read back by ``ACRApp.unpack_stream``: "event" on their
# own event, "waited" of those whose event had not passed when it was
# called, "sync" through ``readback`` (outputs not on one card)
READBACK: Dict[str, int] = collections.Counter()


def readback(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One synchronisation of the whole device, then every output to host
    numpy: image mode's ``device_step``, the throughput path's chunks,
    the tools, and ``unpack_stream`` where the step's outputs are not on
    one card."""
    if any(v.is_cuda for v in out.values()):
        torch.cuda.synchronize()
    return {k: v.cpu().numpy() for k, v in out.items()}


class StreamOutputs(dict):
    """A stream step's device outputs, with ``host``: a pinned host tensor
    per output, its copy enqueued on the step's stream; ``started`` and
    ``copied``: timing events recorded at the front of the step and after
    those copies; and ``waited_s``: the seconds ``unpack_stream`` waited
    for ``copied``."""

    host: Dict[str, torch.Tensor]
    started: torch.cuda.Event
    copied: torch.cuda.Event
    waited_s: float = 0.0

    def device_s(self) -> float:
        """Device seconds from the step's front to its copies' event; once
        unpacked."""
        return self.started.elapsed_time(self.copied) / 1e3


def _enqueue_readback(out: Dict[str, torch.Tensor],
                      started: Optional[torch.cuda.Event]
                      ) -> Dict[str, torch.Tensor]:
    """``out`` with its copies to pinned host memory enqueued and a timing
    event after them, where every output is on one card and ``started`` was
    recorded there; else ``out`` as it is. Each output gets its own pinned
    tensor from the caching host allocator, so an array a caller keeps
    holds only its own output's memory, and no later step's copy reuses it
    while it lives."""
    devices = {v.device for v in out.values()}
    device = devices.pop() if len(devices) == 1 else None
    if device is None or device.type != "cuda" or started is None:
        return out
    res = StreamOutputs(out)
    res.host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                for k, v in out.items()}
    res.started = started
    with torch.cuda.device(device):
        for k, v in out.items():
            res.host[k].copy_(v, non_blocking=True)
        res.copied = torch.cuda.Event(enable_timing=True)
        res.copied.record()
    return res


def _state_map(fn, *trees):
    """``fn`` over the leaves of OneEuro state trees (NamedTuples of
    tensors), leaf by leaf; the results in the first tree's shape."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    return type(trees[0])(*(_state_map(fn, *leaves)
                            for leaves in zip(*trees)))


def probe_reduce(per_frame: torch.Tensor) -> torch.Tensor:
    """A chunk's capacity probe from its frames' (B, 4) probes [max
    faces/tile, tiles over, max faces/band, bands over]: the worst tile
    and band, and the overflowing tiles and bands summed over the frames."""
    return torch.stack([per_frame[:, 0].max(), per_frame[:, 1].sum(),
                        per_frame[:, 2].max(), per_frame[:, 3].sum()]
                       ).to(torch.int32)


def _render_frames(viz, out: Dict[str, torch.Tensor], probe: bool
                   ) -> Dict[str, torch.Tensor]:
    """A device render per frame of ``out`` into ``_rgba`` (B, 4, S, S),
    and with ``probe`` each frame's capacity probe into ``_probe_frames``
    (B, 4)."""
    frames = range(out["verts"].shape[0])
    res = {"_rgba": torch.stack([viz.render_rgba_device(out, batch_idx=k)
                                 for k in frames])}
    if probe:
        res["_probe_frames"] = torch.stack([
            viz.overflow_probe_device(out, batch_idx=k) for k in frames])
    return res


class ACRApp:
    """Owns the pipeline, the visualizer, the OneEuro state and the
    output directory. ``device`` is ``cuda`` unless the caller asks for
    the CPU; without a card a CUDA device raises. ``devices`` names the
    replica devices under ``data_parallel > 1`` (``ACRPipeline``)."""

    def __init__(self, cfg: Config, params=None, device="cuda",
                 merge_params=None, devices=None):
        self.cfg = cfg
        if cfg.renderer == "native" or not cfg.jit_translation_solve:
            from acr_tpu_torch.io import native
            native.library()            # raises when it cannot be built
        hamer_params = None
        if cfg.architecture == "hamer" and params is not None:
            hamer_params = {k[len("hamer."):]: v for k, v in params.items()
                            if k.startswith("hamer.")}
            params = {k: v for k, v in params.items()
                      if not k.startswith("hamer.")}
        self.timer = SpanTimer()
        # the detector: ACR's network, or ViTDet-H and ViTPose-H; either is
        # the pipeline the step calls first, and owns its span, its
        # preprocess, the hands it hands on and its counts
        if cfg.detector == "vitdet":
            from acr_tpu_torch.pipeline.vitdet import ViTDetPipeline
            self.pipeline = ViTDetPipeline(cfg, params=params, device=device)
            self.pipeline.stage = self.timer.stage
        else:
            self.pipeline = ACRPipeline(cfg, params=params, device=device,
                                        merge_params=merge_params,
                                        devices=devices)
        mesh = self.pipeline.mesh
        # the architecture's regress stage, if any, and the output that
        # its mesh tail (``ACRPipeline.refine``) takes as the camera
        self.regressor = None
        self._camera = "cam"
        faces = self.pipeline.faces
        if cfg.architecture == "hamer":
            # HaMeR regresses both hands from ACR's detections
            self.regressor = hamer.Regressor(cfg, hamer_params,
                                             self.pipeline.mano_r,
                                             self.pipeline.device)
            self.pipeline.tail = self.regressor.tail
            self._camera = self.regressor.CAMERA
            faces = hamer.mirrored_faces(faces[1])
        self.visualizer = None
        self._replica_viz = {}
        if cfg.save_visualization_on_img and cfg.renderer != "none":
            from acr_tpu_torch.viz.visualizer import Visualizer
            self.visualizer = Visualizer(cfg, faces,
                                         device=self.pipeline.device)
            # the per-frame render of each replica's shard, on its device
            self._replica_viz = {self.pipeline.device: self.visualizer}
            for rep in self.pipeline.replicas[1:]:
                if rep.device not in self._replica_viz:
                    self._replica_viz[rep.device] = Visualizer(
                        cfg, faces, device=rep.device)
        # the chunk step renders on the device unless the frames are drawn
        # on the host or wait for the host translation solve
        self._render_in_step = (self.visualizer is not None
                                and cfg.renderer == "tpu"
                                and cfg.jit_translation_solve)
        # why the chunk step does not run sharded under a mesh (JAX's
        # reasons, acr_tpu/pipeline/app.py:270-279)
        self._fused_bypass_reason = None
        if mesh is not None and cfg.temporal_optimization:
            self._fused_bypass_reason = (
                "data_parallel with -t: the OneEuro scan is sequential "
                "across frames")
        elif mesh is not None and cfg.val_batch_size % mesh.size:
            self._fused_bypass_reason = (
                f"val_batch_size={cfg.val_batch_size} does not divide "
                f"over the {mesh.size}-device mesh")
        self._sharded_chunk = (mesh is not None
                               and self._fused_bypass_reason is None)
        # every process holds every output; one of them writes the files
        self._writes = mesh is None or mesh.rank == 0
        # the auxiliary views drawn beside each rendered frame
        self.aux_items = [] if self.visualizer is None else \
            [i for i in cfg.show_items if i != "mesh"]
        self._need_maps = "centermap" in self.aux_items
        self.filter_state = init_two_hand_filter(self.pipeline.device)
        # the step's input staging, its smooth and render stages through
        # CUDA graphs at b1 (pipeline.graphs), and the OneEuro state the
        # smooth graph reads
        self._inputs = graphs.Inputs(self.pipeline.device)
        self._regress_graph = graphs.StepGraph("regress", self.pipeline.device)
        self._smooth_graph = graphs.StepGraph("smooth", self.pipeline.device)
        self._render_graph = graphs.StepGraph("render", self.pipeline.device)
        self._graph_state = None
        self.output_dir = cfg.output_dir or "./demos_outputs/"
        self._frame_idx = 0
        self._probe_frame_idx = 0
        self._imshow_warned = False
        self.last_output: Optional[Dict[str, np.ndarray]] = None
        self._name_map: Dict[str, str] = {}
        self._used_names: set = set()

    def _step(self, image, offsets, *, render: bool, probe: bool,
              return_maps: bool = False) -> Dict[str, torch.Tensor]:
        """The device work of a batch of frames, image uint8 (B, S, S, 3)
        and offsets (B, 10), issued in order: the forward (``issue.forward``;
        with ``return_maps`` its centre maps), the architecture's regress
        stage (``issue.regress``, HaMeR's), with ``-t`` OneEuro over the
        frames in order and the architecture's tail (``issue.smooth``), and
        with ``render`` a render per frame into ``_rgba`` (B, 4, S, S) and,
        with ``probe``, the reduced capacity probe (``issue.render``).
        Nothing is read back but the banded render's gates (at 1024 px and
        above). Each stage replays its CUDA graph where ``graph_block``
        finds none of its reasons, the render only below 1024 px; the
        frame's host inputs are then staged once, first
        (``graphs.Inputs``), and every stage reads them on the device."""
        timer = self.timer
        image = torch.as_tensor(image)
        offsets = torch.as_tensor(offsets, dtype=torch.float32)
        why = self.pipeline.graph_block(image.shape[0])
        with torch.no_grad():
            with timer.stage(self.pipeline.span):
                staged = self._inputs(why, {"image": image, "offsets": offsets})
                image, offsets = staged["image"], staged["offsets"]
                out = self.pipeline(image, offsets, return_maps=return_maps,
                                    why=why)
            if self.regressor is not None:
                with timer.stage("issue.regress"):
                    out.update(self._regress(why, image, out, offsets))
            if self.cfg.temporal_optimization:
                with timer.stage("issue.smooth"):
                    out.update(self._smooth(why, out, offsets))
            if render:
                with timer.stage("issue.render"):
                    out.update(self._render(why, out, probe))
        return out

    def _refine(self, d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The architecture's mesh tail on ``d``: the pipeline's refine."""
        return self.pipeline.refine(d["poses"], d["betas"], d[self._camera],
                                    d["offsets"])

    def _regress(self, why: Optional[str], image: torch.Tensor,
                 out: Dict[str, torch.Tensor], offsets: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        """The regressor on the detections in ``out``, then the mesh tail
        on its poses and betas; eagerly with the nested stages
        ``regress.crop`` and ``regress.net``."""
        hamer.CROPS["crops"] += 2 * image.shape[0]
        inputs = dict(self.pipeline.hand_inputs(image, out),
                      detection_flag=out["detection_flag"], offsets=offsets)

        def regress(d, stage=contextlib.nullcontext):      # no spans
            image, joints, valid = self.pipeline.hands(d)
            res = self.regressor.regress(image, joints, valid,
                                         d["detection_flag"], stage)
            res.update(self._refine(dict(res, offsets=d["offsets"])))
            return res
        return self._regress_graph(why, None, regress, inputs,
                                   eager=lambda d: regress(d, self.timer.stage))

    def _smooth(self, why: Optional[str], out: Dict[str, torch.Tensor],
                offsets: torch.Tensor) -> Dict[str, torch.Tensor]:
        """OneEuro over the frames in order, advancing ``filter_state``
        (per-hand gating by the detection flag happens on the device),
        then the architecture's tail on the smoothed poses and betas.
        Through its graph the stage reads the OneEuro state from static
        tensors and writes the new state into them in place;
        ``filter_state`` is that tree from then on, and a tree put in its
        place is copied in first."""
        def smooth(d):
            self.filter_state, poses, betas = smooth_sequence(
                self.filter_state, d["poses"], d["betas"],
                d["detection_flag"], self.cfg.smooth_coeff)
            res = {"poses": poses, "betas": betas}
            res.update(self._refine(dict(d, **res)))
            return res

        def in_place(d):
            res = smooth(d)
            _state_map(torch.Tensor.copy_, static, self.filter_state)
            self.filter_state = static
            return res

        static = self._graph_state
        if why is None:
            if static is None:
                static = self._graph_state = _state_map(
                    torch.clone, self.filter_state)
            elif self.filter_state is not static:
                _state_map(torch.Tensor.copy_, static, self.filter_state)
            self.filter_state = static
        inputs = {k: out[k] for k in ("poses", "betas", "detection_flag",
                                      self._camera)}
        inputs["offsets"] = offsets
        return self._smooth_graph(why, None, in_place, inputs, eager=smooth)

    def _render(self, why: Optional[str], out: Dict[str, torch.Tensor],
                probe: bool) -> Dict[str, torch.Tensor]:
        """``_render_frames`` on the visualizer, with the probe reduced
        over the frames into ``_raster_overflow``."""
        if why is None and self.cfg.render_size >= 1024:
            why = "render_size"              # banded_fits reads the host

        def render(d):
            res = _render_frames(self.visualizer, d, probe)
            if probe:
                res["_raster_overflow"] = probe_reduce(res.pop("_probe_frames"))
            return res
        return self._render_graph(why, probe, render,
                                  {k: out[k] for k in ("verts", "cam_trans",
                                                       "detection_flag")})

    def chunk_step(self, image, offsets) -> Dict[str, torch.Tensor]:
        """The throughput path's device work for one chunk of frames,
        image uint8 (B, S, S, 3) and offsets (B, 10) (JAX's
        ``_chunk_step``): ``_step`` over the chunk, the OneEuro state
        carried across chunks, with the render unless the frames are drawn
        on the host or wait for the host solve, and the centre maps when
        the ``centermap`` view is asked for. Under a mesh the forward and
        the render run sharded when the frames are independent (JAX's
        ``_chunk_step_dp``), and the probe is reduced over the gathered
        chunk."""
        render = self._render_in_step
        probe = render and self.cfg.raster_overflow_every > 0
        if not self._sharded_chunk:
            return self._step(image, offsets, render=render, probe=probe,
                              return_maps=self._need_maps)

        def shard(rep, img, off):
            out = self.pipeline.forward_on(rep, img, off, self._need_maps)
            if render:
                out.update(_render_frames(self._replica_viz[rep.device], out,
                                          probe))
            return out
        with torch.no_grad():
            out = self.pipeline.run_sharded(
                shard, torch.as_tensor(image),
                torch.as_tensor(offsets, dtype=torch.float32))
            if probe:
                out["_raster_overflow"] = probe_reduce(out.pop("_probe_frames"))
        return out

    def _frame_step(self, meta: Dict, probe: bool, return_maps: bool = False
                    ) -> Dict[str, torch.Tensor]:
        """``_step`` on one frame, rendered with ``renderer='tpu'``; its
        ``_rgba`` (4, S, S)."""
        out = self._step(meta["image"], meta["offsets"],
                         render=self.visualizer is not None
                         and self.cfg.renderer == "tpu",
                         probe=probe, return_maps=return_maps)
        if "_rgba" in out:
            out["_rgba"] = out["_rgba"][0]
        return out

    def device_step(self, meta: Dict) -> Dict[str, np.ndarray]:
        """The device work of ``process_frame`` (the capacity probe every
        ``raster_overflow_every`` frames, the centre maps for the
        ``centermap`` view), then one readback."""
        every = self.cfg.raster_overflow_every
        out = self._frame_step(meta, probe=bool(every)
                               and self._frame_idx % every == 0,
                               return_maps=self._need_maps)
        self._frame_idx += 1
        out = readback(out)
        self.pipeline.count(out)
        return out

    def stream_step(self, meta: Dict) -> Dict[str, torch.Tensor]:
        """The streaming loop's step: the device work of one frame, with
        the capacity probe in every step when it is on, and no host wait.
        On a card the outputs' copies to pinned host memory are enqueued
        behind that work, with an event after them (``StreamOutputs``).
        Read it back with :meth:`unpack_stream`."""
        started = None
        device = self.pipeline.device
        if device.type == "cuda":
            started = torch.cuda.Event(enable_timing=True)
            started.record(torch.cuda.current_stream(device))
        return _enqueue_readback(
            self._frame_step(meta, probe=self.cfg.raster_overflow_every > 0),
            started)

    def unpack_stream(self, out: Dict[str, torch.Tensor]) -> Dict:
        """The stream step's one readback: a wait for the step's own event
        and numpy arrays over its pinned copies (the wait's seconds in
        ``out.waited_s``), else ``readback``; logs the probe."""
        copied = getattr(out, "copied", None)
        if copied is None:
            READBACK["sync"] += 1
            out = readback(out)
        else:
            READBACK["event"] += 1
            if not copied.query():
                READBACK["waited"] += 1
                t0 = time.perf_counter()
                copied.synchronize()
                out.waited_s = time.perf_counter() - t0
            out = {k: v.numpy() for k, v in out.host.items()}
        self._consume_overflow_probe(out, n_frames=1)
        self.pipeline.count(out)
        return out

    def _consume_overflow_probe(self, out: Dict, n_frames: int = 1):
        """Pop the capacity-probe counts (if present) and log them: every
        ``raster_overflow_every`` rendered frames, and always when a tile
        or band overflowed."""
        overflow = out.pop("_raster_overflow", None)
        if overflow is None:
            return
        every = self.cfg.raster_overflow_every
        prev = self._probe_frame_idx
        self._probe_frame_idx = prev + n_frames
        stats = [int(x) for x in np.asarray(overflow).reshape(-1)]
        due = not every or prev == 0 \
            or prev // every != self._probe_frame_idx // every
        if stats[1] or stats[3] or due:
            self._log_overflow(*stats)

    def _log_overflow(self, max_tile: int, n_over: int,
                      max_band: int = 0, n_band_over: int = 0):
        if n_over:
            how = ("the frame was rendered by the exact flat kernel"
                   if self.cfg.render_size >= 1024 else
                   "the binned kernel drew those tiles exactly from the "
                   "full face table")
            log.warning(
                "binned rasterizer overflow: %d tiles above capacity "
                "(max %d faces/tile) at render_size=%d — %s", n_over,
                max_tile, self.cfg.render_size, how)
        if n_band_over:
            log.warning(
                "banded rasterizer overflow: %d row bands above the band "
                "table capacity (max %d faces/band) at render_size=%d — the "
                "frame was rendered by the exact flat kernel even though "
                "every tile is under BIN_CAP", n_band_over, max_band,
                self.cfg.render_size)
        if not (n_over or n_band_over):
            log.debug("raster capacity probe: max %d faces/tile, "
                      "max %d faces/band, 0 overflows", max_tile, max_band)

    def process_frame(self, bgr_frame: np.ndarray, path: str
                      ) -> Dict[str, list]:
        """Full per-frame stack; returns the reference-format results dict."""
        with self.timer.stage("preprocess", path):
            meta = self.pipeline.preprocess(bgr_frame, path,
                                    input_size=self.cfg.input_size)
        with self.timer.stage("device_step", path):
            out = self.device_step(meta)
        self.last_output = out              # the frame's host outputs
        overflow = out.pop("_raster_overflow", None)
        if overflow is not None:
            self._log_overflow(*[int(x) for x in overflow.reshape(-1)])

        if not out["detection_flag"].any():
            log.info("no hand detected: %s", path)
            self._emit_frame(bgr_frame, path)
            return {path: []}

        if not self.cfg.jit_translation_solve:
            self._host_translation(out)

        results = reorganize_results(out, [path])
        if self.visualizer is not None:
            with self.timer.stage("render", path):
                if "_rgba" in out:
                    rendered = self.visualizer.compose_on_frame(
                        out["_rgba"], bgr_frame, meta, planar=True)
                else:
                    rendered = self.visualizer.render_on_frame(
                        bgr_frame, out, meta)
            with self.timer.stage("encode", path):
                self._emit_frame(rendered, path)
            if self.aux_items:
                self._emit_aux(out, meta, path)
        else:
            self._emit_frame(bgr_frame, path)
        return results

    def _host_translation(self, out: Dict[str, np.ndarray]):
        """Replace the device's LS translation with the native host RANSAC
        solve per hand (``jit_translation_solve=False``), keeping the
        device value where the host system is singular."""
        from acr_tpu_torch.io import native
        j3d = out["j3d"]
        pj_px = (out["pj2d"] + 1.0) * (self.cfg.input_size / 2.0)
        half = self.cfg.input_size / 2.0
        trans = np.zeros_like(out["cam_trans"])
        for b in range(j3d.shape[0]):
            for hand in range(2):
                try:
                    trans[b, hand] = native.estimate_translation(
                        j3d[b, hand], pj_px[b, hand],
                        focal=float(self.cfg.focal_length), cx=half, cy=half)
                except ValueError:
                    trans[b, hand] = out["cam_trans"][b, hand]
        out["cam_trans"] = trans

    def _emit_aux(self, out: Dict, meta: Dict, path: str):
        """Write (or show) one frame's auxiliary views; ``out`` holds the
        frame's host outputs with a batch axis of 1."""
        for name, view in self.visualizer.aux_views(
                out, meta, self.aux_items).items():
            self._emit_frame(view[:, :, ::-1], self._aux_path(path, name))

    @staticmethod
    def _aux_path(path: str, item: str) -> str:
        base, ext = os.path.splitext(os.path.basename(path))
        return f"{base}_{item}{ext or '.jpg'}"

    def _emit_frame(self, bgr_frame: np.ndarray, path: str):
        if not self._writes:
            return
        if self.cfg.demo_mode == "webcam" or not self.cfg.save_visualization_on_img:
            # webcam mode displays every frame like the reference
            # (acr/main.py:110-111); a host without a display warns once
            if self.cfg.demo_mode == "webcam" or self.cfg.interactive_vis:
                try:
                    import cv2
                    cv2.imshow("acr_tpu_torch", bgr_frame)
                    cv2.waitKey(1)
                except Exception as exc:           # headless: no display
                    if not self._imshow_warned:
                        log.warning("cv2.imshow unavailable (%s); "
                                    "frames not displayed", exc)
                        self._imshow_warned = True
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
        if self.cfg.save_dict_results and self._writes:
            save_results(imgpath, self.output_dir, results)
        return results

    def run_folder(self) -> Dict:
        """Folder mode (and video mode, after splitting the video into
        frames), in name order, the OneEuro state carried across frames
        with ``-t``: ``process_frame`` per frame at ``val_batch_size=1``,
        the throughput path ``_run_batched`` above it."""
        inputs = self.cfg.inputs
        if not inputs or not os.path.exists(inputs):
            raise FileNotFoundError(f"--inputs not found: {inputs}")
        if os.path.isdir(inputs):
            image_folder = inputs.rstrip("/")
        else:
            image_folder = split_frame(inputs)          # video file -> frames
        self.output_dir = self.cfg.output_dir or (
            "./demos_outputs/" + os.path.basename(image_folder) +
            f"_results_{self.cfg.centermap_conf_thresh}/")
        file_list = collect_image_list(image_folder)
        log.info("running on %d frames from %s", len(file_list), image_folder)
        import cv2
        results: Dict = {}
        t0 = time.time()
        if self.cfg.val_batch_size > 1 and file_list:
            results = self._run_batched(file_list)
        else:
            for imgpath in file_list:
                frame = cv2.imread(imgpath)
                if frame is None:
                    log.warning("skipping unreadable image: %s", imgpath)
                    continue
                results.update(self.process_frame(frame, imgpath))
        dt = time.time() - t0
        if file_list:
            log.info("%d frames in %.2fs (%.2f FPS)",
                     len(file_list), dt, len(file_list) / dt)
            log.info("per-stage latency: %s",
                     {k: f"{v['avg_ms']:.1f}ms"
                      for k, v in self.timer.report().items()})
        if (self.cfg.save_visualization_on_img and self.visualizer is not None
                and self._writes):
            save_video(self.output_dir,
                       os.path.join(self.output_dir,
                                    os.path.basename(image_folder) + "_output"))
        if self.cfg.save_dict_results and self._writes:
            save_results(image_folder, self.output_dir, results)
        return results

    run_video = run_folder    # video mode = split to frames, then folder mode

    def _run_batched(self, file_list) -> Dict:
        """Throughput path: chunks of ``val_batch_size`` frames through
        ``chunk_step``, one readback per chunk.

        The last chunk is padded by repeating its final frame and its
        outputs are trimmed; with ``-t`` the padded frames only advance
        the OneEuro state after the last real frame, as in JAX. Each frame
        is decoded and preprocessed once, on a producer thread that
        prepares the next chunk (host work only) while the device runs
        the current one; the upload happens here, in the consumer, and an
        exception of the producer is raised here.
        """
        import queue
        import threading

        import cv2
        bs = self.cfg.val_batch_size
        # JAX's per-stage path, and why (acr_tpu/pipeline/app.py:612-626)
        why = (self._fused_bypass_reason
               or ("host translation solve"
                   if not self.cfg.jit_translation_solve else None)
               or (f"renderer={self.cfg.renderer}"
                   if self.visualizer is not None
                   and self.cfg.renderer != "tpu" else None))
        if why:
            log.info("fused chunk step bypassed (%s); using the per-stage "
                     "path", why)

        def read_frame(path):
            frame = cv2.imread(path)
            if frame is None:
                log.warning("unreadable image, substituting black: %s", path)
                frame = np.zeros((64, 64, 3), np.uint8)
            return frame

        def prep_chunk(batch_paths):
            t0 = time.perf_counter()
            frames = [read_frame(p) for p in batch_paths]
            metas = [self.pipeline.preprocess(f, p,
                                              input_size=self.cfg.input_size)
                     for f, p in zip(frames, batch_paths)]
            img_c = np.concatenate([m["image"] for m in metas])
            off_c = np.concatenate([m["offsets"] for m in metas])
            pad = bs - len(img_c)
            if pad:
                img_c = np.concatenate(
                    [img_c, np.repeat(img_c[-1:], pad, axis=0)])
                off_c = np.concatenate(
                    [off_c, np.repeat(off_c[-1:], pad, axis=0)])
            prep_ms = (time.perf_counter() - t0) * 1e3
            return batch_paths, frames, metas, img_c, off_c, pad, prep_ms

        chunk_q: "queue.Queue" = queue.Queue(maxsize=1)

        def producer():
            try:
                for i in range(0, len(file_list), bs):
                    chunk_q.put(("ok", prep_chunk(file_list[i:i + bs])))
            except BaseException as exc:          # raised in the consumer
                chunk_q.put(("error", exc))
            chunk_q.put(("done", None))

        threading.Thread(target=producer, daemon=True,
                         name="acr-chunk-prefetch").start()

        results: Dict = {}
        while True:
            kind, payload = chunk_q.get()
            if kind == "done":
                break
            if kind == "error":
                raise payload
            batch_paths, frames, metas, img_c, off_c, pad, prep_ms = payload
            self.timer.add("preprocess", prep_ms)
            with self.timer.stage("device_step"):
                o = readback(self.chunk_step(img_c, off_c))
                self._consume_overflow_probe(o, n_frames=len(batch_paths))
                self.pipeline.count(o)
            keep = bs - pad
            chunk = {k: v[:keep] for k, v in o.items()}
            if not self.cfg.jit_translation_solve:
                self._host_translation(chunk)
            self.last_output = chunk            # the chunk's host outputs
            rgba = chunk.get("_rgba")
            results.update(reorganize_results(chunk, batch_paths))

            for k, (path, frame, meta) in enumerate(
                    zip(batch_paths, frames, metas)):
                if (self.visualizer is None
                        or not chunk["detection_flag"][k].any()):
                    self._emit_frame(frame, path)
                    continue
                one = {key: v[k:k + 1] for key, v in chunk.items()}
                with self.timer.stage("render", path):
                    if rgba is not None:
                        rendered = self.visualizer.compose_on_frame(
                            rgba[k], frame, meta, planar=True)
                    else:
                        rendered = self.visualizer.render_on_frame(
                            frame, one, meta)
                self._emit_frame(rendered, path)
                if self.aux_items:
                    self._emit_aux(one, meta, path)
        return results

    def run_webcam(self):
        from acr_tpu_torch.pipeline.capture import WebcamVideoStream
        from acr_tpu_torch.pipeline.streaming import TURNS, StreamingLoop
        cap = WebcamVideoStream(self.cfg.cam_id).start()

        def show(rendered, _out):
            self._emit_frame(rendered, "0")

        loop = StreamingLoop(self, on_result=show)
        # the p50 log reads the loop's stream.frame spans
        recording, self.timer.recording = self.timer.recording, True
        try:
            loop.run(cap)
        finally:
            cap.stop()
            self.timer.recording = recording
            spans = self.timer.spans()
            frame_ms = [(t1 - t0) * 1e3 for name, _, _, t0, t1 in spans
                        if name == "stream.frame"]
            regress_ms = [(t1 - t0) * 1e3 for name, _, _, t0, t1 in spans
                          if name == "issue.regress"]
            if frame_ms:
                log.info("webcam p50 frame latency: %.1f ms%s; step graphs %s; "
                         "readbacks %s; turns %s%s",
                         float(np.percentile(frame_ms, 50)),
                         f" (issue.regress p50 {np.percentile(regress_ms, 50):.2f}"
                         " ms)" if regress_ms else "", dict(graphs.COUNTS),
                         dict(READBACK), dict(TURNS),
                         self.pipeline.counts_text())

    def run(self) -> Optional[Dict]:
        mode = self.cfg.demo_mode
        if mode == "image":
            return self.run_image()
        if mode in ("video", "folder"):
            return self.run_folder()
        if mode == "webcam":
            return self.run_webcam()
        raise ValueError(f"unknown demo_mode: {mode}")
