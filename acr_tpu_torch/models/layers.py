"""Building-block modules for the ACR network, in PyTorch (NCHW).

Counterpart of ``acr_tpu/models/layers.py``. Module and parameter names
follow the flax tree, so a flax path ``a/b/kernel`` is the state-dict
key ``a.b.weight`` (``acr_tpu_torch.io.params.from_flax``):

* BatchNorm is a folded affine (``FoldedBN``): ``x * scale + bias`` per
  channel, the converter's precomputed ``gamma / sqrt(var + eps)`` and
  ``beta - mean * scale``.
* Convs use explicit symmetric torch padding (default ``k // 2``), the
  padding the JAX package spells out for flax (``layers.py:41-62``).

Only the canonical blocks are here: the TPU lane-padding and
space-to-depth rewrites are not part of the port. Inside the network
tensors are NCHW; the helpers below take NCHW too.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class FoldedBN(nn.Module):
    """Inference BatchNorm folded to a per-channel affine."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return x * self.scale[:, None, None] + self.bias[:, None, None]


def conv(in_ch: int, features: int, kernel: int, stride: int = 1,
         pad: int | None = None, use_bias: bool = False) -> nn.Conv2d:
    """Torch Conv2d with explicit symmetric padding (default k//2)."""
    if pad is None:
        pad = kernel // 2
    return nn.Conv2d(in_ch, features, kernel, stride=stride, padding=pad,
                     bias=use_bias)


class ConvBN(nn.Module):
    """conv -> folded BN -> optional ReLU."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True, use_bias: bool = False):
        super().__init__()
        self.conv = conv(in_ch, features, kernel, stride, use_bias=use_bias)
        self.bn = FoldedBN(features)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class BasicBlock(nn.Module):
    """Residual basic block (reference: acr/model.py:470-499)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv(in_ch, features, 3, stride)
        self.bn1 = FoldedBN(features)
        self.conv2 = conv(features, features, 3, 1)
        self.bn2 = FoldedBN(features)
        self.downsample = downsample
        if downsample:
            self.down_conv = conv(in_ch, features, 1, stride, pad=0)
            self.down_bn = FoldedBN(features)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = self.down_bn(self.down_conv(x)) if self.downsample else x
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """Residual bottleneck, expansion 4 (reference: acr/model.py:501-539)."""
    EXPANSION = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out_feats = features * self.EXPANSION
        self.conv1 = conv(in_ch, features, 1, 1, pad=0)
        self.bn1 = FoldedBN(features)
        self.conv2 = conv(features, features, 3, stride)
        self.bn2 = FoldedBN(features)
        self.conv3 = conv(features, out_feats, 1, 1, pad=0)
        self.bn3 = FoldedBN(out_feats)
        self.downsample = downsample
        if downsample:
            self.down_conv = conv(in_ch, out_feats, 1, stride, pad=0)
            self.down_bn = FoldedBN(out_feats)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = self.down_bn(self.down_conv(x)) if self.downsample else x
        return F.relu(out + residual)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """NCHW nearest-neighbor upsample by an integer factor."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def downsample_nearest_half(x: torch.Tensor) -> torch.Tensor:
    """NCHW nearest downsample by 2 (torch F.interpolate(scale=0.5, 'nearest'))."""
    return x[:, :, ::2, ::2]


def resize_bilinear_align_corners(x: torch.Tensor,
                                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """NCHW bilinear resize with align_corners=True."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)


def get_coord_maps(size: int = 128, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """(1, 2, size, size) CoordConv xy grid in [-1, 1].

    Channel 0 varies along width (x), channel 1 along height (y)
    (reference: acr/model.py:340-369); the values are those of the JAX
    package's (1, size, size, 2) grid.
    """
    r = torch.arange(size, dtype=torch.float32, device=device) / (size - 1) * 2 - 1
    xx = r[None, :].expand(size, size)
    yy = r[:, None].expand(size, size)
    return torch.stack([xx, yy], dim=0)[None].to(dtype)
