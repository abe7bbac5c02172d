"""Flax-path checkpoints -> PyTorch state dicts, and the seeded init.

The JAX package stores weights as a flat npz whose keys are '/'-joined
flax parameter paths (``acr_tpu/io/params.py``). The port's modules
carry the same names, so a path maps to a state-dict key by joining
with '.' and renaming the leaf:

* conv ``kernel`` HWIO -> ``weight`` OIHW;
* ``nn.Dense`` ``kernel`` (in, out) -> ``weight`` (out, in);
* ``FoldedBN`` ``scale`` / ``bias`` and every ``bias`` keep their names;
* ``LocallyConnected.w`` (O, C, J) is kept as is;
* a quantized tree's int8 ``kernel_q`` HWIO -> OIHW int8, and its fp32
  ``wscale`` (Co,) and ``ascale`` (``()`` or (Ci,)) as they are
  (``ops.quant.QuantConv``); every other leaf becomes float32.

The canonical tree only: checkpoints on disk are canonical
(``acr_tpu/pipeline/infer.py:183-193``). The merge-mode fusion head
(``parser/fusion_fc``) lives outside the network; ``split_parser``
takes it out first.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

PARSER_PREFIX = "parser/"


def _reference_net(net: Optional[nn.Module]) -> nn.Module:
    if net is not None:
        return net
    from acr_tpu_torch.models.acr import ACRNet
    with torch.device("meta"):
        return ACRNet()


def split_parser(flat: Dict[str, np.ndarray]
                 ) -> Tuple[Dict[str, np.ndarray], Optional[Dict[str, torch.Tensor]]]:
    """Take the merge-mode ``parser/fusion_fc`` leaves out of a flat tree.

    Returns (network leaves, {'weight' (out,in), 'bias'} or None)."""
    net_flat = {k: v for k, v in flat.items() if not k.startswith(PARSER_PREFIX)}
    fc = {k[len(PARSER_PREFIX + "fusion_fc/"):]: v for k, v in flat.items()
          if k.startswith(PARSER_PREFIX + "fusion_fc/")}
    if not fc:
        return net_flat, None
    return net_flat, {
        "weight": torch.from_numpy(np.ascontiguousarray(
            np.asarray(fc["kernel"], np.float32).T)),
        "bias": torch.from_numpy(np.asarray(fc["bias"], np.float32).copy()),
    }


def from_flax(flat: Dict[str, np.ndarray],
              net: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """{flax path: array} -> state dict of ``net`` (default: canonical
    float ACRNet; a quantized tree needs ``ACRNet(quantize=mode)``).

    Raises KeyError on any leaf the network does not use and on any
    parameter the tree does not provide, and ValueError on a shape that
    does not fit.
    """
    expected = {k: tuple(v.shape) for k, v in
                _reference_net(net).state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        parts = path.split("/")
        leaf = parts[-1]
        if leaf == "kernel_q":
            arr = np.asarray(value, np.int8).transpose(3, 2, 0, 1)
        else:
            arr = np.asarray(value, np.float32)
        if leaf == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
            elif arr.ndim == 2:
                arr = arr.T                              # (in,out) -> (out,in)
            else:
                raise ValueError(f"{path}: kernel of rank {arr.ndim}")
            leaf = "weight"
        out[".".join(parts[:-1] + [leaf])] = torch.tensor(arr)
    unused = sorted(set(out) - set(expected))
    missing = sorted(set(expected) - set(out))
    if unused or missing:
        raise KeyError(f"flax tree does not fit the network: "
                       f"unused {unused[:8]} ({len(unused)}), "
                       f"missing {missing[:8]} ({len(missing)})")
    for key, shape in expected.items():
        if tuple(out[key].shape) != shape:
            raise ValueError(f"{key}: shape {tuple(out[key].shape)}, "
                             f"network wants {shape}")
    return out


def load_params(path: str, net: Optional[nn.Module] = None):
    """npz of flax paths -> (state dict, merge-mode fusion head or None).

    The JAX package also reads an orbax checkpoint directory
    (``acr_tpu/io/params.py:78-83``); the port does not."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"not ported to acr_tpu_torch yet: model_path={path!r} is a "
            "directory (an orbax checkpoint); the port reads npz files of "
            "flax paths: ROADMAP C5")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    net_flat, fusion = split_parser(flat)
    return from_flax(net_flat, net), fusion


def init_params(generator: torch.Generator,
                net: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Seeded full-width random weights with flax's initializers.

    Conv and Dense kernels: lecun normal (truncated at 2 sigma, fan-in
    scaled, as ``nn.initializers.lecun_normal``); biases 0;
    ``LocallyConnected.w`` normal(1.0); folded-BN ``scale`` 0.2, the
    golden recipe (tests/golden/make_fixture.py:31-33) that keeps the
    activations of a random network finite.
    """
    out: Dict[str, torch.Tensor] = {}
    # truncated normal of unit variance after truncation at +-2
    trunc_std = 0.87962566103423978
    for key, ref in _reference_net(net).state_dict().items():
        shape = tuple(ref.shape)
        leaf = key.rsplit(".", 1)[-1]
        t = torch.empty(shape, dtype=torch.float32)
        if leaf == "weight":
            fan_in = int(np.prod(shape[1:]))
            std = math.sqrt(1.0 / fan_in) / trunc_std
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        elif leaf == "w":
            nn.init.normal_(t, 0.0, 1.0, generator=generator)
        elif leaf == "scale":
            t.fill_(0.2)
        elif leaf == "bias":
            t.zero_()
        else:
            raise KeyError(f"no init rule for {key}")
        out[key] = t
    return out
