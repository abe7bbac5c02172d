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

The other way: ``flax_paths`` lists the flax paths and shapes of the
canonical network (JAX's ``enumerate_flax_paths``, read from the port's
``ACRNet`` on the meta device), ``to_flax`` turns a state dict back into
flax leaves, and ``save_params_npz`` writes the npz JAX's
``save_params_npz`` writes, atomically (``savez_atomic``).

Checkpoints on disk are an npz of flax paths or an orbax directory
(``io/orbax.py``); ``load_params`` takes either, as JAX's does, and
``flatten_params`` / ``unflatten_params`` / ``load_params_npz`` /
``save_params_orbax`` / ``load_params_orbax`` are JAX's functions on
numpy trees.
"""

from __future__ import annotations

import math
import os
import uuid
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from acr_tpu_torch.io import orbax as _orbax

PARSER_PREFIX = "parser/"


def flatten_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Nested {'params': {...}} tree -> {'a/b/c': array} (the params level
    stripped), as JAX's ``flatten_params``. Leaves become numpy arrays; a
    torch tensor (an orbax tree's bf16 leaf) stays as it is."""
    tree = params.get("params", params)
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(prefix + (k,), v)
        else:
            flat["/".join(prefix)] = (node if isinstance(node, torch.Tensor)
                                      else np.asarray(node))

    rec((), tree)
    return flat


def unflatten_params(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{'a/b/c': array} -> {'params': nested dict}, the leaves kept as
    they are (JAX's makes them jnp arrays)."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return {"params": root}


def load_params_npz(path: str) -> Dict[str, Any]:
    """An npz of flax paths -> {'params': nested dict of numpy arrays}."""
    with np.load(path) as data:
        return unflatten_params({k: data[k] for k in data.files})


def save_params_orbax(path: str, params: Dict[str, Any]) -> None:
    """Write a params tree as an orbax checkpoint directory that JAX's
    ``load_params_orbax`` (and ``load_params_orbax`` here) reads back to
    the same leaves: normalized to a {'params': ...} tree as JAX's
    ``save_params_orbax`` does, and replacing an existing checkpoint.
    The layout is orbax's without OCDBT (``io.orbax.save_orbax``), where
    JAX's orbax writes OCDBT."""
    flat = flatten_params(params)
    _orbax.save_orbax(path, {("params",) + tuple(k.split("/")): v
                             for k, v in flat.items()})


def load_params_orbax(path: str) -> Dict[str, Any]:
    """An orbax checkpoint directory -> {'params': nested dict}: the leaves
    of JAX's ``load_params_orbax``, as numpy arrays, a bf16 leaf as a
    torch.bfloat16 tensor (``io.orbax.load_orbax``)."""
    return unflatten_params(flatten_params(_orbax.load_orbax(path)))


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


def _flax_leaf(key: str, shape: Tuple[int, ...]):
    """State-dict key and shape -> (flax path tuple, flax shape, the
    permutation that takes the torch array to flax's layout or None)."""
    parts = key.split(".")
    leaf = parts[-1]
    perm = None
    if leaf == "weight":
        leaf = "kernel"
        perm = (2, 3, 1, 0) if len(shape) == 4 else (1, 0)   # OIHW -> HWIO
    elif leaf == "kernel_q":
        perm = (2, 3, 1, 0)
    path = tuple(parts[:-1]) + (leaf,)
    if perm is not None:
        shape = tuple(shape[i] for i in perm)
    return path, tuple(shape), perm


def flax_paths(net: Optional[nn.Module] = None
               ) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """{flax path tuple: flax shape} of ``net`` (default: the canonical
    float ACRNet, built on the meta device), in JAX's order: a params
    tree's keys sorted at every level, as ``jax.eval_shape`` returns them
    (``tools/convert_checkpoint.py:145`` ``enumerate_flax_paths``).
    The inverse of the leaf renames of ``from_flax``."""
    out = {}
    for key, ref in _reference_net(net).state_dict().items():
        path, shape, _ = _flax_leaf(key, tuple(ref.shape))
        out[path] = shape
    return {p: out[p] for p in sorted(out)}


def to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of ``from_flax``: a state dict (float, or quantized)
    -> {'/'-joined flax path: array}, conv kernels OIHW -> HWIO, Dense
    (out, in) -> (in, out), in JAX's order (``flax_paths``)."""
    flat = {}
    for key, value in state_dict.items():
        arr = value.detach().cpu().numpy()
        path, _, perm = _flax_leaf(key, tuple(arr.shape))
        if perm is not None:
            arr = arr.transpose(perm)
        flat[path] = np.ascontiguousarray(arr)
    return {"/".join(p): flat[p] for p in sorted(flat)}


def save_params_npz(path: str, state_dict: Dict[str, torch.Tensor],
                    merge_params: Optional[Dict[str, torch.Tensor]] = None
                    ) -> None:
    """Write ``state_dict`` as the npz of flax paths that JAX's
    ``acr_tpu.io.params.save_params_npz`` writes for the same weights
    (and ``load_params`` / JAX's ``load_params_npz`` read); with
    ``merge_params`` (``split_parser``'s {'weight', 'bias'}), the
    ``parser/fusion_fc`` leaves after the network's, where JAX's
    converter puts them."""
    flat = to_flax(state_dict)
    if merge_params is not None:
        flat["parser/fusion_fc/kernel"] = np.ascontiguousarray(
            merge_params["weight"].detach().cpu().numpy().T)
        flat["parser/fusion_fc/bias"] = \
            merge_params["bias"].detach().cpu().numpy()
    savez_atomic(path, flat)


def savez_atomic(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez(path, **arrays)`` into a temporary file beside ``path``,
    then ``os.replace`` onto it: a reader, or another process writing the
    same file, sees the old file or the whole new one, never a part. The
    temporary name is unique and ends in ``.npz``, so ``np.savez`` keeps
    it; the file is created as ``np.savez`` creates any. As with
    ``np.savez``, a ``path`` without the suffix gets ``.npz``."""
    if not path.endswith(".npz"):
        path += ".npz"
    tmp = f"{path}.{uuid.uuid4().hex}.tmp.npz"
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


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
    """A checkpoint of flax paths -> (state dict, merge-mode fusion head
    or None). ``path`` is an npz file or, as JAX's ``load_params`` takes
    it (``acr_tpu/io/params.py:78-83``), an orbax checkpoint directory
    (``load_params_orbax``); both go through the same ``split_parser``
    and ``from_flax``."""
    if os.path.isdir(path):
        flat = flatten_params(load_params_orbax(path))
    else:
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
    # a bf16 leaf of an orbax tree widens to fp32 exactly
    flat = {k: v.float().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in flat.items()}
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
