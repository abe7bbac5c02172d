"""End-to-end inference: uint8 frame batch -> hands, on one torch device.

Counterpart of ``acr_tpu/pipeline/infer.py``:

    backbone -> heads -> center decode -> parameter sampling ->
    cross-hand prior -> 6D decode -> MANO -> weak-persp projection ->
    metric translation solve -> original-image keypoint mapping

with fixed shapes: both hands always occupy a slot (axis 1: [left,
right]) and ``detection_flag`` is data, not control flow, so the chain
issues device work only and reads nothing back.

fp32 means fp32: building a pipeline turns TF32 off for cuDNN
convolutions and cuBLAS matmuls (cuDNN runs fp32 convolutions in TF32
by default, about three significant digits).

``model_precision="bf16"`` runs the network in bf16 on weights cast once
at load; the maps stay bf16 and the parser casts what it samples, so
MANO and everything after it run in fp32. ``quantize`` keeps the float
weights, calibrates the int8 activation scales at load on the committed
frames (``ops.quant``) and serves the W8A8 network in the compute dtype.

``data_parallel > 1`` keeps one copy of the network and the MANO assets
per local replica of the mesh (``parallel.mesh``), made once at load;
a call pads the batch to a multiple of the global replica count, runs
each of this process's shards on its replica and gathers the outputs on
the lead replica (from every process, on every process).
"""

from __future__ import annotations

import contextlib
import copy
import logging
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from acr_tpu_torch.config import Config
from acr_tpu_torch.io.params import load_params
from acr_tpu_torch.models.acr import ACRNet
from acr_tpu_torch.models.mano import ManoModel, load_mano_model, mano_forward
from acr_tpu_torch.ops.mano_kernel import (
    ManoKernelData,
    build_kernel_data,
    mano_forward_fused,
)
from acr_tpu_torch.ops.quant import (
    committed_calibration_frames,
    quantize_for_net,
)
from acr_tpu_torch.parallel.mesh import (
    gather_outputs,
    init_distributed,
    make_mesh,
    pad_batch,
    split_batch,
)
from acr_tpu_torch.parser.parse import parse_outputs
from acr_tpu_torch.pipeline import graphs, hamer
from acr_tpu_torch.pipeline.project import (
    estimate_translation_ls,
    kp2d_to_org_image,
    weak_persp_project,
)
from acr_tpu_torch.utils.device import resolve_device

log = logging.getLogger("acr_tpu_torch")


def check_slice(cfg: Config) -> None:
    """Every option value of ``Config`` runs in the port, so nothing
    raises here. The TPU layout rewrites (``s2d_*``, ``merged_heads``)
    are not options of the port: it builds the canonical network
    whatever they say."""


def set_fp32_math() -> None:
    """Full fp32 in cuDNN convolutions and cuBLAS matmuls (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def cast_params(net: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every float parameter of ``net`` to ``dtype`` once, in place:
    the bf16 path's pre-cast weights, rounded to nearest even like JAX's
    cast (``acr_tpu/pipeline/infer.py:200-211``). QuantConv's int8 kernel
    and fp32 scales are buffers and keep their dtypes. A no-op in fp32."""
    for p in net.parameters():
        if p.dtype != dtype:
            p.data = p.data.to(dtype)
    return net


class ManoAuto(NamedTuple):
    """Both MANO representations of one side, dispatched by batch size."""
    model: ManoModel
    kernel: ManoKernelData


# The smallest batch (hands per MANO call) from which mano_forward_fused
# is no slower than the pure mano_forward: in chip_smoke.py's sweep over
# B in {8, 64, 256, 512, 1024, 4096} (phase_times_throughput) on an
# NVIDIA H100 80GB HBM3 at a 700 W power limit, the fused path launched
# fewer device events and took less device time at every B. Below about
# 1024 hands both paths are bound by their launches, and their CUDA-event
# times are within the host's noise of each other (PERF.md). The JAX
# package's 512 was measured on a TPU.
PALLAS_MANO_MIN_BATCH = 8


def _apply_mano(mano, poses, betas, center_idx, add_mean=True):
    """Dispatch on the asset type: the fused kernel path or the pure
    path. ``ManoAuto`` takes the fused path from
    ``PALLAS_MANO_MIN_BATCH`` hands per call."""
    if isinstance(mano, ManoAuto):
        if poses.shape[0] >= PALLAS_MANO_MIN_BATCH:
            return mano_forward_fused(mano.kernel, poses, betas,
                                      center_idx=center_idx, add_mean=add_mean)
        return mano_forward(mano.model, poses, betas, center_idx=center_idx,
                            add_mean=add_mean)
    if isinstance(mano, ManoKernelData):
        return mano_forward_fused(mano, poses, betas, center_idx=center_idx,
                                  add_mean=add_mean)
    return mano_forward(mano, poses, betas, center_idx=center_idx,
                        add_mean=add_mean)


def _mano_projection_tail(mano_l, mano_r, poses, betas, cam, offsets,
                          cfg: Config) -> Dict[str, torch.Tensor]:
    """MANO -> weak-persp -> translation -> org-image tail.

    poses (B,2,48), betas (B,2,10), cam (B,2,3), offsets (B,10).
    """
    align = cfg.align_idx if cfg.mano_mesh_root_align else None
    verts_l, j3d_l, _ = _apply_mano(mano_l, poses[:, 0], betas[:, 0], align)
    verts_r, j3d_r, _ = _apply_mano(mano_r, poses[:, 1], betas[:, 1], align)
    verts = torch.stack([verts_l, verts_r], dim=1)      # (B, 2, 778, 3)
    j3d = torch.stack([j3d_l, j3d_r], dim=1)            # (B, 2, 21, 3)
    verts_camed = weak_persp_project(verts, cam, keep_dim=True)
    pj2d = weak_persp_project(j3d, cam)                 # [-1, 1]
    pj2d_px = (pj2d + 1.0) * (cfg.input_size / 2.0)     # reference: utils.py:404
    cam_trans = estimate_translation_ls(
        j3d, pj2d_px, focal=cfg.focal_length,
        img_size=(cfg.input_size, cfg.input_size))
    return {
        "verts": verts, "j3d": j3d, "verts_camed": verts_camed,
        "pj2d": pj2d, "pj2d_org": kp2d_to_org_image(pj2d, offsets[:, None, :]),
        "cam_trans": cam_trans,
    }


def mano_refine_fn(mano_l, mano_r, poses: torch.Tensor, betas: torch.Tensor,
                   cam: torch.Tensor, offsets: torch.Tensor, cfg: Config
                   ) -> Dict[str, torch.Tensor]:
    """MANO + projection only, for re-running after temporal smoothing.

    poses (B,2,48), betas (B,2,10), cam (B,2,3), offsets (B,10).
    """
    return _mano_projection_tail(mano_l, mano_r, poses, betas, cam,
                                 offsets, cfg)


def forward_fn(net: ACRNet, mano_l, mano_r, image: torch.Tensor,
               offsets: torch.Tensor, cfg: Config, return_maps: bool = False,
               merge_params: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """(net, manos, uint8 image (B,S,S,3), offsets (B,10)) -> output dict
    with hand axis [left, right]."""
    outputs = net(image)
    parsed = parse_outputs(
        outputs,
        conf_thresh=cfg.centermap_conf_thresh,
        prior_mode=cfg.prior_mode if cfg.inter_prior else "none",
        prior_gate_px=cfg.prior_gate_px,
        centermap_size=cfg.centermap_size,
        merge_params=merge_params,
        nms_kernel=cfg.kernel_sizes[-1],
        max_hand=cfg.max_hand,
        rot_type=cfg.Rot_type,
        rot_dim=cfg.rot_dim,
        theta_num=cfg.mano_theta_num,
        beta_dim=cfg.beta_dim)
    out = {
        "params": parsed.params,
        "cam": parsed.cam,
        "poses": parsed.poses,
        "betas": parsed.betas,
        "detection_flag": parsed.detection_flag,
        "centers": parsed.centers,
        "centers_conf": parsed.centers_conf,
    }
    out.update(_mano_projection_tail(mano_l, mano_r, parsed.poses,
                                     parsed.betas, parsed.cam, offsets, cfg))
    if return_maps:
        out["l_center_map"] = outputs["l_center_map"].float()
        out["r_center_map"] = outputs["r_center_map"].float()
        out["segms"] = outputs["segms"].float()
    return out


class Replica(NamedTuple):
    """One replica's copy of what the forward reads, on its device."""
    device: torch.device
    net: ACRNet
    mano_l: object
    mano_r: object
    merge_params: Optional[Dict[str, torch.Tensor]]


def _tree_to(tree, device: torch.device):
    """A MANO asset (a NamedTuple of tensors, or of such NamedTuples) on
    ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return type(tree)(*(_tree_to(x, device) for x in tree))


def device_guard(device: torch.device):
    """``torch.cuda.device(device)`` for a card, no guard for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ACRPipeline:
    """Owns the network, the MANO assets and the device.

    ``params`` is a float state dict of the canonical ACRNet
    (``init_params`` or ``io.params.from_flax``); None loads
    ``cfg.model_path``, an npz of flax paths or an orbax checkpoint
    directory (``io.params.load_params``). ``merge_params`` is the
    merge-mode fusion head, kept in fp32. ``device`` is ``cuda`` unless the
    caller asks for the CPU; without a card a CUDA device raises. Under
    ``cfg.data_parallel > 1``, ``devices`` names this process's replica
    devices (a card may repeat); by default they are the first local
    cards, or the CPU for ``device="cpu"`` (``parallel.mesh.make_mesh``).
    """

    def __init__(self, cfg: Config, params: Optional[Dict[str, torch.Tensor]] = None,
                 device="cuda", merge_params=None,
                 devices: Optional[Sequence] = None):
        check_slice(cfg)
        self.mesh = None
        if cfg.data_parallel > 1:
            # join the processes first (the config's coordinator, else the
            # ACR_* environment), so the mesh knows its rank and world
            if cfg.coordinator:
                init_distributed(cfg.coordinator, cfg.num_processes,
                                 cfg.process_id)
            else:
                init_distributed()
            self.mesh = make_mesh(cfg.data_parallel, devices, device)
            self.device = self.mesh.lead
        else:
            self.device = resolve_device(device)
        set_fp32_math()
        self.cfg = cfg
        self.dtype = (torch.bfloat16 if cfg.model_precision == "bf16"
                      else torch.float32)
        self.replicas: List[Replica] = []
        if params is None:
            params, merge_params = load_params(cfg.model_path)
        self.merge_params = None if merge_params is None else {
            k: v.to(self.device) for k, v in merge_params.items()}
        if cfg.quantize == "none":
            self.net = self._network(params)
        else:
            # W8A8 (ops/quant.py): calibrated at load on the committed
            # frames; .calibrate(frames) recalibrates from the float weights
            self._float_params = params
            self.calibrate()
        self.mano_l, faces_l = load_mano_model(cfg.mano_model_path, "left",
                                               device=self.device)
        self.mano_r, faces_r = load_mano_model(cfg.mano_model_path, "right",
                                               device=self.device)
        self.faces = np.stack([faces_l, faces_r])      # (2, 1538, 3)
        # 'on' always takes the fused kernel, 'auto' from
        # PALLAS_MANO_MIN_BATCH hands per call (on the CPU the fused path
        # runs the kernel's plain version)
        if cfg.use_pallas_mano == "on":
            self.mano_l = build_kernel_data(self.mano_l)
            self.mano_r = build_kernel_data(self.mano_r)
        elif cfg.use_pallas_mano == "auto":
            self.mano_l = ManoAuto(self.mano_l, build_kernel_data(self.mano_l))
            self.mano_r = ManoAuto(self.mano_r, build_kernel_data(self.mano_r))
        self._replicate()

    def _replicate(self) -> None:
        """``replicas``: the lead (this pipeline's own net and assets),
        then a copy of the network (bf16 or int8 as served) and the MANO
        assets for each other local replica of the mesh. Also the forward's
        graphs, none captured yet: a graph reads the network it was
        captured on."""
        self._graph = graphs.StepGraph("forward", self.device)
        lead = Replica(self.device, self.net, self.mano_l, self.mano_r,
                       self.merge_params)
        self.replicas = [lead]
        for dev in (self.mesh.devices[1:] if self.mesh is not None else ()):
            self.replicas.append(Replica(
                dev, copy.deepcopy(self.net).to(dev),
                _tree_to(self.mano_l, dev), _tree_to(self.mano_r, dev),
                None if self.merge_params is None else
                {k: v.to(dev) for k, v in self.merge_params.items()}))

    def _network(self, state_dict: Dict[str, torch.Tensor],
                 quantize: str = "none") -> ACRNet:
        """The network on the device, in the compute dtype, holding
        ``state_dict`` (float, or quantized for ``quantize``)."""
        cfg = self.cfg
        net = ACRNet(inter_prior=cfg.inter_prior,
                     head_block_num=cfg.head_block_num,
                     params_ch=cfg.map_channels,
                     offset_mode=cfg.offset_mode, dtype=self.dtype,
                     quantize=quantize)
        net.load_state_dict(state_dict, strict=True)
        net.eval().requires_grad_(False).to(self.device)
        return cast_params(net, self.dtype)

    def calibrate(self, images=None) -> None:
        """(Re)quantize the int8 path: calibrate the activation scales on
        ``images`` (a list of uint8 (B, S, S, 3) batches) through the float
        network in the compute dtype, and quantize the float weights.

        By default the committed real-frame set (``model_data/calib``),
        or, where it was not built for ``input_size``, the synthetic pair
        with a logged warning. Pass deployment frames for representative
        scales."""
        if self.cfg.quantize == "none":
            raise ValueError("calibrate() needs quantize=int8|int8_pc|"
                             "int8_r|int4w")
        if images is None:
            images = committed_calibration_frames(self.cfg.input_size)
            if images is None:
                log.warning(
                    "int8 activation scales calibrated on SYNTHETIC frames "
                    "(uniform noise + mid-gray); call "
                    "ACRPipeline.calibrate(real_frames) before production "
                    "serving for representative scales (ops/quant.py)")
            else:
                log.info("int8 activation scales calibrated on the "
                         "committed real-frame set (model_data/calib); call "
                         "ACRPipeline.calibrate(real_frames) to recalibrate "
                         "for a specific deployment")
        float_net = self._network(self._float_params)
        quantized = quantize_for_net(float_net, self._float_params,
                                     self.cfg.quantize, images=images,
                                     input_size=self.cfg.input_size)
        del float_net
        self.net = self._network(quantized, self.cfg.quantize)
        if self.replicas:                    # a recalibration after load
            self._replicate()

    @torch.no_grad()
    def __call__(self, image, offsets, return_maps: bool = False
                 ) -> Dict[str, torch.Tensor]:
        """image uint8 (B, S, S, 3), offsets float32 (B, 10); numpy or
        tensors. Returns device tensors (on the lead replica under a mesh).
        On a card at batch 1 without a mesh the forward replays its CUDA
        graph (``pipeline.graphs``), its inputs staged through pinned
        memory, with no host wait; elsewhere it runs eagerly, and a host
        input's copy to a card waits for the stream, as does the gather
        across processes."""
        image = torch.as_tensor(image)
        offsets = torch.as_tensor(offsets, dtype=torch.float32)
        why = self.graph_block(image.shape[0])
        if why is None:
            return self._graph(
                return_maps,
                lambda d: self._forward(d["image"], d["offsets"], return_maps),
                {"image": image, "offsets": offsets})
        graphs.count_eager("forward", why)
        if self.mesh is not None:
            return self.run_sharded(
                lambda rep, img, off: forward_fn(
                    rep.net, rep.mano_l, rep.mano_r, img, off, self.cfg,
                    return_maps=return_maps, merge_params=rep.merge_params),
                image, offsets)
        return self._forward(image.to(self.device), offsets.to(self.device),
                             return_maps)

    def _forward(self, image: torch.Tensor, offsets: torch.Tensor,
                 return_maps: bool) -> Dict[str, torch.Tensor]:
        return forward_fn(self.net, self.mano_l, self.mano_r, image, offsets,
                          self.cfg, return_maps=return_maps,
                          merge_params=self.merge_params)

    def graph_block(self, batch: int) -> Optional[str]:
        """Why a step of ``batch`` frames runs eagerly (``cpu``, ``mesh`` or
        ``batch``), or None where its stages replay CUDA graphs: on a card,
        without a mesh, one frame at a time (``pipeline.graphs``)."""
        if self.device.type != "cuda":
            return "cpu"
        if self.mesh is not None:
            return "mesh"
        if batch != 1:
            return "batch"
        return None

    @torch.no_grad()
    def run_sharded(self, fn: Callable[[Replica, torch.Tensor, torch.Tensor],
                                       Dict[str, torch.Tensor]],
                    image: torch.Tensor, offsets: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        """``fn(replica, image shard, offsets shard)`` for each of this
        process's shards, issued under its replica's device, the batch
        first padded to a multiple of the mesh by repeating its last
        frame; the outputs (batch-leading tensors) gathered on the lead
        replica and trimmed to the batch."""
        mesh = self.mesh
        batch = image.shape[0]
        image, pad = pad_batch(image, mesh.size)
        offsets, _ = pad_batch(offsets, mesh.size)
        images = split_batch(image, mesh.size)
        offs = split_batch(offsets, mesh.size)
        outs = []
        for rep, k in zip(self.replicas, mesh.local_shards()):
            with device_guard(rep.device):
                outs.append(fn(rep, images[k].to(rep.device),
                               offs[k].to(rep.device)))
        out = gather_outputs(mesh, outs)
        if pad:
            out = {k: v[:batch] for k, v in out.items()}
        return out

    @torch.no_grad()
    def refine(self, poses, betas, cam, offsets, boxes=None
               ) -> Dict[str, torch.Tensor]:
        """``mano_refine_fn`` on the pipeline's device; a host input's
        copy to a card waits for the stream. Given ``boxes`` (B, 2, 3), the
        crops of HaMeR's regressor, it is HaMeR's tail instead
        (``pipeline.hamer.tail``): both hands through the right MANO
        without the mean pose or root alignment, and the crops' cameras
        carried to the frame."""
        dev = self.device
        poses, betas, cam = (torch.as_tensor(t).to(dev) for t in (poses, betas, cam))
        offsets = torch.as_tensor(offsets, dtype=torch.float32).to(dev)
        if boxes is not None:
            return hamer.tail(
                lambda p, b: _apply_mano(self.mano_r, p, b, None,
                                         add_mean=False)[:2],
                poses, betas, cam, torch.as_tensor(boxes).to(dev), offsets,
                self.cfg.input_size)
        return mano_refine_fn(self.mano_l, self.mano_r, poses, betas, cam,
                              offsets, self.cfg)
