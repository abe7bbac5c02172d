"""HRNet-W32-style backbone and part-segmentation head in PyTorch.

Counterpart of ``acr_tpu/models/hrnet.py`` in its canonical form only:
stem of two stride-2 3x3 convs, a 4-Bottleneck layer1, then three
multi-resolution stages (1 module / 2 branches, 4 / 3, 3 / 4, channels
[32, 64, 128, 256]) with all-to-all SUM fusion; returns the
highest-resolution branch, (B, 32, 128, 128) for a 512x512 input
(reference: acr/model.py:571-881). The input normalization
``x / 255 * 2 - 1`` stays inside the module, so callers feed raw uint8
frames, as NHWC ``(B, S, S, 3)`` like the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from acr_tpu_torch.models.layers import (
    BasicBlock,
    Bottleneck,
    ConvBN,
    conv,
    resize_bilinear_align_corners,
    upsample_nearest,
)

STAGE2 = {"num_modules": 1, "channels": (32, 64), "num_blocks": 4}
STAGE3 = {"num_modules": 4, "channels": (32, 64, 128), "num_blocks": 4}
STAGE4 = {"num_modules": 3, "channels": (32, 64, 128, 256), "num_blocks": 4}


class HRModule(nn.Module):
    """Parallel multi-resolution branches + all-to-all SUM fuse.

    Branch i runs ``num_blocks`` BasicBlocks at channels[i]; fusion sends
    every branch j to every output branch i (1x1 conv + nearest x2^(j-i)
    upsample for coarse->fine, a chain of stride-2 3x3 convs for
    fine->coarse), summed then ReLU'd (reference: acr/model.py:571-686).
    """

    def __init__(self, channels: Sequence[int], num_blocks: int = 4,
                 multi_scale_output: bool = True):
        super().__init__()
        self.channels = tuple(channels)
        self.num_blocks = num_blocks
        n = len(channels)
        for i in range(n):
            for k in range(num_blocks):
                self.add_module(f"b{i}_{k}",
                                BasicBlock(channels[i], channels[i]))
        self.n_out = n if multi_scale_output else 1
        if n == 1:
            self.n_out = 1
            return
        for i in range(self.n_out):
            for j in range(n):
                if j > i:
                    self.add_module(f"fuse_{i}_{j}", ConvBN(
                        channels[j], channels[i], kernel=1, relu=False))
                elif j < i:
                    for k in range(i - j):
                        last = k == i - j - 1
                        feats = channels[i] if last else channels[j]
                        self.add_module(f"fuse_{i}_{j}_{k}", ConvBN(
                            channels[j], feats, kernel=3, stride=2,
                            relu=not last))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        n = len(self.channels)
        ys = []
        for i in range(n):
            h = xs[i]
            for k in range(self.num_blocks):
                h = getattr(self, f"b{i}_{k}")(h)
            ys.append(h)
        if n == 1:
            return ys
        fused = []
        for i in range(self.n_out):
            acc = None
            for j in range(n):
                if j == i:
                    contrib = ys[j]
                elif j > i:
                    contrib = upsample_nearest(
                        getattr(self, f"fuse_{i}_{j}")(ys[j]), 2 ** (j - i))
                else:
                    contrib = ys[j]
                    for k in range(i - j):
                        contrib = getattr(self, f"fuse_{i}_{j}_{k}")(contrib)
                acc = contrib if acc is None else acc + contrib
            fused.append(F.relu(acc))
        return fused


class SegmNet(nn.Module):
    """Part-segmentation head: 128 -> 256 upsample, 33-class logits.

    bilinear x2 (align_corners) -> DoubleConv(32 -> 16 -> 64) ->
    truncated DoubleConv(64 -> 33 -> 33)
    (reference: acr/model.py:374-463; SegmHead(32, 128, 64, 33)).
    """

    def __init__(self, out_dim: int = 33, in_ch: int = 32):
        super().__init__()
        self.up1 = ConvBN(in_ch, 16, kernel=3, use_bias=True)
        self.up2 = ConvBN(16, 64, kernel=3, use_bias=True)
        self.out1 = ConvBN(64, out_dim, kernel=3, use_bias=True)
        self.out_conv2 = conv(out_dim, out_dim, 3, use_bias=True)

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        x = resize_bilinear_align_corners(x, (h * 2, w * 2))
        return self.out_conv2(self.out1(self.up2(self.up1(x))))


class HRNetBackbone(nn.Module):
    """Stem + layer1 + 3 multi-resolution stages; returns (B,32,S/4,S/4)."""

    def __init__(self):
        super().__init__()
        self.stem1 = ConvBN(3, 64, kernel=3, stride=2)
        self.stem2 = ConvBN(64, 64, kernel=3, stride=2)
        for k in range(4):
            self.add_module(f"layer1_{k}", Bottleneck(
                64 if k == 0 else 256, 64, downsample=(k == 0)))
        self.transition1_0 = ConvBN(256, 32, kernel=3)
        self.transition1_1_0 = ConvBN(256, 64, kernel=3, stride=2)
        for m in range(STAGE2["num_modules"]):
            self.add_module(f"stage2_{m}", HRModule(STAGE2["channels"]))
        self.transition2_2_0 = ConvBN(64, 128, kernel=3, stride=2)
        for m in range(STAGE3["num_modules"]):
            self.add_module(f"stage3_{m}", HRModule(STAGE3["channels"]))
        self.transition3_3_0 = ConvBN(128, 256, kernel=3, stride=2)
        for m in range(STAGE4["num_modules"]):
            last = m == STAGE4["num_modules"] - 1
            self.add_module(f"stage4_{m}", HRModule(
                STAGE4["channels"], multi_scale_output=not last))

    def forward(self, image_uint8: torch.Tensor) -> torch.Tensor:
        """image_uint8 (B, S, S, 3) -> features (B, 32, S/4, S/4)."""
        x = image_uint8.permute(0, 3, 1, 2).to(torch.float32)
        x = x / 255.0 * 2.0 - 1.0
        x = self.stem2(self.stem1(x))
        for k in range(4):
            x = getattr(self, f"layer1_{k}")(x)
        xs = [self.transition1_0(x), self.transition1_1_0(x)]
        for m in range(STAGE2["num_modules"]):
            xs = getattr(self, f"stage2_{m}")(xs)
        xs = xs + [self.transition2_2_0(xs[-1])]
        for m in range(STAGE3["num_modules"]):
            xs = getattr(self, f"stage3_{m}")(xs)
        xs = xs + [self.transition3_3_0(xs[-1])]
        for m in range(STAGE4["num_modules"]):
            xs = getattr(self, f"stage4_{m}")(xs)
        return xs[0]
