"""Seeded full-width weights, made on the device in a few large calls.

Rules (flax's initialisers, as the port's own random checkpoints use
them): conv and dense kernels normal of variance 1 / fan-in, cut at two
standard deviations; the locally connected head's kernel normal(1);
biases 0. Folded-BN scales are 1 on the paths that carry the signal
(every ``ConvBN`` and the projection shortcut) and 0.2 inside the
residual branches (``bn1``..``bn3``), so that the activations stay
finite and the features that reach the heads follow the frame (with 0.2
everywhere the CoordConv channels drown the image by some 1e4 and every
frame gives the same hands). Then the "near" scene: the 1x1 fuse convs
that emit each hand's 109 parameters and the prior heads' output convs
are damped by 0.005, the fuse biases set to the camera (5, -+0.3, 0),
identity 6D rotations at five times unit length (the 6D columns are
normalised, so the rotations stay well away from the representation's
singular columns and from pi) and zero betas, and the centre heads'
output kernels scaled by 0.1 and raised by 1.5, so both hands are
detected on every frame, posed around MANO's mean pose, and move from
frame to frame with the image. The weights are returned in the dtype
they are served in.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from port_bench.reference.network import param_shapes

SCENE = {"cam": (5.0, 0.3, 0.0), "rot6d": 5.0, "fuse_gain": 0.005,
         "prior_gain": 0.005, "center_gain": 0.1, "center_bias": 1.5,
         "bn_signal": 1.0, "bn_residual": 0.2}


def make_weights(seed: int, device, dtype=torch.float32,
                 input_size: int = 512) -> Dict[str, torch.Tensor]:
    spec = param_shapes(input_size)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    random = [(n, s) for n, s in spec if n.endswith((".weight", ".w"))]
    total = sum(math.prod(s) for _, s in random)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in random:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if name.endswith(".weight"):
            # unit variance after the cut at 2 sigma: std / 0.8796
            t = t.clamp(-2.0, 2.0) * (math.sqrt(1.0 / math.prod(shape[1:]))
                                      / 0.87962566103423978)
        out[name] = t
    for name, shape in spec:
        if name not in out:
            fill = 0.0
            if name.endswith((".bn.scale", ".down_bn.scale")):
                fill = SCENE["bn_signal"]
            elif name.endswith(".scale"):
                fill = SCENE["bn_residual"]
            out[name] = torch.full(shape, fill, device=device)
    cam = SCENE["cam"]
    ident = SCENE["rot6d"] * torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0],
                                          device=device)
    for side, sign in (("l", -1.0), ("r", 1.0)):
        w = out[f"{side}_fuse_conv.weight"] * SCENE["fuse_gain"]
        w[:3] = 0.0
        out[f"{side}_fuse_conv.weight"] = w
        out[f"{side}_fuse_conv.bias"] = torch.cat([
            torch.tensor([cam[0], sign * cam[1], cam[2]], device=device),
            ident.repeat(16), torch.zeros(10, device=device)])
        out[f"{side}_prior_head.out.weight"] = \
            out[f"{side}_prior_head.out.weight"] * SCENE["prior_gain"]
        out[f"{side}_center_head.out.weight"] = \
            out[f"{side}_center_head.out.weight"] * SCENE["center_gain"]
        out[f"{side}_center_head.out.bias"] = \
            out[f"{side}_center_head.out.bias"] + SCENE["center_bias"]
    return {k: v.to(dtype).contiguous() for k, v in out.items()}
