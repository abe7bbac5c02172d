"""W8A8 int8 inference for the conv-heavy regions of the network.

Counterpart of ``acr_tpu/ops/quant.py``, the path behind
``Config.quantize`` ('int8', 'int8_pc', 'int8_r', 'int4w'):

* weights: per-output-channel symmetric int8 (scale = max|w| / qmax),
  quantized from the float state dict (``quantize_tree_int8``);
* activations: symmetric int8 with static scales calibrated by running
  the float network over frames with a forward pre-hook on every
  quantized conv (``calibrate_amax``), which records the per-input-
  channel amax of its input. Scales are per tensor, or per input channel
  under '_pc', folded exactly into the weights before their quantization;
* quant(0) == 0, so the zero padding of the int8 product is exact.

The product is ``int8_conv2d``: an explicit im2col of the int8 input and
``torch._int_mm``, whose int32 sums are exact and so equal XLA's int8
convolution (``preferred_element_type=int32``) bit for bit. No path falls
back to a float convolution. The same function runs on the CPU.

Which convs are quantized (``is_quant_site``) is exactly the JAX
package's set of ``quant_conv`` call sites: every conv of the backbone,
the segm head, the head stacks' transition and blocks, ``contact_conv``
and ``cam_shape_conv``; the heads' 1x1 ``out`` convs and the
``{l,r}_fuse_conv`` only under '_r'; never ``LocallyConnected`` or the
shape ``Linear``.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# torch._int_mm on CUDA takes M > 16 and K, N multiples of 8; smaller
# operands are padded with zero rows and columns, which add nothing
_MIN_M = 17
_ALIGN = 8


def _pad_to(n: int, align: int) -> int:
    return -(-n // align) * align


def int8_conv2d(xq: torch.Tensor, w: torch.Tensor, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """(B, Ci, H, W) int8 conv (Co, Ci, kh, kw) int8 -> (B, Co, Ho, Wo)
    int32, exact: zero padding, an im2col by ``Tensor.unfold`` (columns
    ordered (Ci, kh, kw) like the OIHW kernel's rows) and ``torch._int_mm``
    against the kernel as a column-major (K, Co) matrix."""
    b, ci, _, _ = xq.shape
    co, _, kh, kw = w.shape
    if padding:
        xq = F.pad(xq, (padding,) * 4)
    cols = xq.permute(0, 2, 3, 1).unfold(1, kh, stride).unfold(2, kw, stride)
    ho, wo = cols.shape[1:3]
    m, k = b * ho * wo, ci * kh * kw
    cols = cols.reshape(m, k)
    wm = w.reshape(co, k)
    mp = max(m, _MIN_M)
    kp, n_p = _pad_to(k, _ALIGN), _pad_to(co, _ALIGN)
    if (mp, kp) != (m, k):
        cols = F.pad(cols, (0, kp - k, 0, mp - m))
    if (n_p, kp) != (co, k):
        wm = F.pad(wm, (0, kp - k, 0, n_p - co))
    y = torch._int_mm(cols, wm.t())
    if (mp, n_p) != (m, co):
        y = y[:m, :co]
    return y.reshape(b, ho, wo, co).permute(0, 3, 1, 2)


def int8_conv2d_plain(xq: torch.Tensor, w: torch.Tensor, stride: int = 1,
                      padding: int = 0) -> torch.Tensor:
    """The plain version of ``int8_conv2d``: a float64 convolution of the
    integer values, exact while every sum stays below 2^53, cast to int32."""
    return F.conv2d(xq.double(), w.double(), stride=stride,
                    padding=padding).to(torch.int32)


class QuantConv(nn.Module):
    """W8A8 conv: static-scale int8 quantize -> int8 conv -> dequant, in
    the dtype of its input (``acr_tpu/ops/quant.py`` ``QuantConv``).

    Buffers ``kernel_q`` (int8, OIHW), ``wscale`` (Co,) and ``ascale``
    (``()``, or (Ci,) with ``per_channel``, whose inverse is already folded
    into ``kernel_q`` and ``wscale``), written by ``quantize_tree_int8``,
    and the float ``bias`` parameter.
    """

    def __init__(self, in_ch: int, features: int, kernel: int,
                 stride: int = 1, pad: int = 0, use_bias: bool = False,
                 per_channel: bool = False):
        super().__init__()
        self.stride, self.pad, self.per_channel = stride, pad, per_channel
        self.register_buffer("kernel_q", torch.zeros(
            (features, in_ch, kernel, kernel), dtype=torch.int8))
        self.register_buffer("wscale", torch.ones(features))
        self.register_buffer("ascale", torch.ones(
            (in_ch,) if per_channel else ()))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """The int8 activation: clip(round(x * ascale), -127, 127), with
        round half to even, as ``jnp.round``."""
        asc = self.ascale[:, None, None] if self.per_channel else self.ascale
        return torch.clamp(torch.round(x.float() * asc), -127, 127
                           ).to(torch.int8)

    def forward(self, x):
        y = int8_conv2d(self.quantize(x), self.kernel_q, self.stride, self.pad)
        deq = self.wscale if self.per_channel else self.wscale / self.ascale
        y = (y.float() * deq[:, None, None]).to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)[:, None, None]
        return y


def is_quant_site(name: str, mode: str) -> bool:
    """Whether the conv module at ``name`` of ACRNet is quantized by
    ``mode``: the regressors (a head's 1x1 ``out`` conv, a fuse conv)
    only under '_r' (``acr_tpu/models/acr.py:81-83,282-285``)."""
    regressor = name.endswith(("_head.out", "_fuse_conv"))
    return mode.endswith("_r") or not regressor


def _sites(net: nn.Module, mode: str) -> List[str]:
    return [name for name, mod in net.named_modules()
            if isinstance(mod, nn.Conv2d) and is_quant_site(name, mode)]


def quantize_modules(net: nn.Module, mode: str) -> nn.Module:
    """Replace every float conv that ``mode`` quantizes by a QuantConv of
    the same geometry (in place; returns ``net``)."""
    for name in _sites(net, mode):
        conv = net.get_submodule(name)
        parent, _, child = name.rpartition(".")
        setattr(net.get_submodule(parent), child, QuantConv(
            conv.in_channels, conv.out_channels, conv.kernel_size[0],
            conv.stride[0], conv.padding[0], conv.bias is not None,
            per_channel=mode.endswith("_pc")))
    return net


def calibrate_amax(net: nn.Module, images, mode: str = "int8"
                   ) -> Dict[str, np.ndarray]:
    """Run the float network ``net`` over ``images`` (uint8 (B, S, S, 3)
    batches) and return {conv name: per-input-channel input amax}, the
    elementwise max over the batches: the JAX package's observe run, as
    forward pre-hooks on the convs that ``mode`` quantizes. The amax is
    taken of the input in the network's own dtype, cast to float32."""
    stats: Dict[str, torch.Tensor] = {}

    def recorder(name):
        def record(_module, args):
            amax = args[0].float().abs().amax(dim=(0, 2, 3))
            stats[name] = amax if name not in stats else \
                torch.maximum(stats[name], amax)
        return record

    device = next(net.parameters()).device
    handles = [net.get_submodule(name).register_forward_pre_hook(
        recorder(name)) for name in _sites(net, mode)]
    try:
        with torch.no_grad():
            for img in images:
                net(torch.as_tensor(np.asarray(img)).to(device))
    finally:
        for h in handles:
            h.remove()
    return {k: v.cpu().numpy() for k, v in stats.items()}


def default_calibration_frames(input_size: int):
    """Synthetic structural-bound calibration set: uniform noise
    (near-extreme activations through the normalize) + mid-gray. The
    LAST-RESORT default — committed_calibration_frames (real frames)
    is preferred when its artifact exists."""
    r = np.random.RandomState(0)
    return [r.randint(0, 255, (1, input_size, input_size, 3)
                      ).astype(np.uint8),
            np.full((1, input_size, input_size, 3), 127, np.uint8)]


def committed_calibration_frames(input_size: int):
    """The committed real-frame calibration set
    (``model_data/calib/calib_frames.npz``: preprocessed variants of the
    reference demo photo and the two synthetic structural bounds). Returns
    a list of (1, S, S, 3) uint8 batches, or None when the file is absent
    or was built for another input size (callers then fall back to
    ``default_calibration_frames``)."""
    path = os.path.join(_REPO_ROOT, "model_data", "calib", "calib_frames.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        frames = np.asarray(z["frames"], np.uint8)
    if frames.ndim != 4 or frames.shape[1] != input_size \
            or frames.shape[2] != input_size:
        return None
    return [frames[i:i + 1] for i in range(frames.shape[0])]


def quantize_for_net(float_net: nn.Module, state_dict: Dict[str, torch.Tensor],
                     mode: str, images=None, input_size: int = 512
                     ) -> Dict[str, torch.Tensor]:
    """One-call quantization for ``mode``: calibrate ``float_net`` (the
    float ACRNet holding ``state_dict``, in the serving dtype) on
    ``images`` (default: the committed real-frame set, else the synthetic
    one) and quantize ``state_dict``'s float weights. '_pc' takes
    per-input-channel scales, 'int4w' the weight grid [-7, 7]."""
    if images is None:
        images = committed_calibration_frames(input_size) \
            or default_calibration_frames(input_size)
    stats = calibrate_amax(float_net, images, mode)
    return quantize_tree_int8(state_dict, stats,
                              per_channel=mode.endswith("_pc"),
                              weight_bits=4 if mode == "int4w" else 8)


def quantize_tree_int8(state_dict: Dict[str, torch.Tensor],
                       stats: Dict[str, np.ndarray], margin: float = 1.0,
                       per_channel: bool = False, weight_bits: int = 8
                       ) -> Dict[str, torch.Tensor]:
    """Float state dict + calibration stats -> the quantized state dict.

    Every conv in ``stats`` has its float ``weight`` replaced by
    ``kernel_q``, ``wscale`` and ``ascale``; biases and folded-BN
    parameters are kept. With ``per_channel`` the (Ci,) activation scales
    are floored at 1e-4 of the site's per-tensor amax and their inverse is
    folded into the kernel before its per-output-channel quantization.
    ``weight_bits`` 8 gives the grid [-127, 127], 4 gives [-7, 7]
    ('int4w'). The arithmetic is ``acr_tpu/ops/quant.py``'s in numpy, in
    the kernel's OIHW layout (every step is elementwise or a max)."""
    qmax = float((1 << (weight_bits - 1)) - 1)
    out = dict(state_dict)
    for site, val in stats.items():
        if f"{site}.weight" not in out:                 # already quantized
            continue
        k = np.asarray(out.pop(f"{site}.weight"), np.float32)
        amax_c = np.asarray(val, np.float32).reshape(-1)
        amax_t = max(float(amax_c.max()) * margin, 1e-12)
        if per_channel:
            amax_c = np.maximum(amax_c * margin, amax_t * 1e-4)
            s_c = (127.0 / amax_c).astype(np.float32)   # (Ci,)
            # fold 1/s_c into the kernel over its input axis
            k = k / s_c[None, :, None, None]
            ascale = s_c
        else:
            ascale = np.float32(127.0 / amax_t)
        wmax = np.maximum(np.abs(k).reshape(k.shape[0], -1).max(1), 1e-12)
        ws = (wmax / qmax).astype(np.float32)
        out[f"{site}.kernel_q"] = torch.from_numpy(np.clip(
            np.round(k / ws[:, None, None, None]), -qmax, qmax
        ).astype(np.int8))
        out[f"{site}.wscale"] = torch.from_numpy(ws)
        out[f"{site}.ascale"] = torch.tensor(ascale)
    return out
