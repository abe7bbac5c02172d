"""Convert the reference torch checkpoint (wild.pkl) to an npz of flax paths.

Counterpart of ``tools/convert_checkpoint.py``; it writes the same npz,
which both packages load. It replaces the reference's runtime checkpoint
surgery (torch.load + ``module.`` prefix stripping + tolerant
copy_state_dict; reference: acr/utils.py:1106-1168, acr/main.py:59) with
a one-time offline conversion, in numpy float32:

* conv weights     (O, I, kh, kw) -> (kh, kw, I, O)
* linear weights   (O, I)         -> (I, O)
* BatchNorm        (gamma, beta, running_mean, running_var) folded to
                   the inference affine: scale = gamma/sqrt(var+1e-5),
                   bias = beta - mean*scale
* LocallyConnected (1, O, C, J, 1, 1) -> (O, C, J)

Unmapped torch keys (e.g. the unused ``segmentation_layers`` head,
acr/model.py:262-286, and the torch ManoLayer buffers) are reported and
dropped, mirroring the reference's tolerant load. The flax paths come
from the port's network (``io.params.flax_paths``).

Usage:
  python -m acr_tpu_torch.tools.convert_checkpoint \\
      --torch_ckpt checkpoints/wild.pkl --out checkpoints/wild.npz
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from acr_tpu_torch.io.params import flax_paths, savez_atomic
from acr_tpu_torch.io.torch_names import map_flax_path


def _to_numpy_state_dict(path: str) -> dict:
    """torch.load -> flat {name: ndarray}, hardened for the checkpoint
    container variants seen in the wild (the reference's load tolerates
    arbitrary state dicts, acr/utils.py:1106-1168, acr/main.py:59):

    * a bare (Ordered)Dict state dict — the `wild.pkl` shape;
    * a training checkpoint wrapping it under 'model_state_dict' /
      'state_dict' / 'model' (optimizer/epoch entries are dropped);
    * a whole pickled nn.Module (``.state_dict()`` is taken; its class
      must be importable);
    * repeated DataParallel prefixes ('module.module.' etc.);
    * non-tensor values (epoch counters, None, strings) — skipped with
      a notice rather than crashing the conversion.
    """
    import torch
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict") and not isinstance(obj, dict):
        obj = obj.state_dict()
    if isinstance(obj, dict):
        for key in ("model_state_dict", "state_dict", "model"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    if not isinstance(obj, dict):
        raise ValueError(f"unsupported checkpoint container: {type(obj)}")
    out, skipped = {}, []
    for k, v in obj.items():
        while k.startswith("module."):
            k = k[len("module."):]
        if hasattr(v, "detach"):
            out[k] = v.detach().cpu().numpy()
            continue
        try:
            arr = np.asarray(v)
        except Exception:
            skipped.append(k)
            continue
        if arr.dtype == object or arr.dtype.kind in "USV" or v is None:
            skipped.append(k)
        else:
            out[k] = arr
    if skipped:
        print(f"skipped {len(skipped)} non-tensor entries, e.g.:",
              *skipped[:5], sep="\n  ")
    return out


def convert_state_dict(torch_sd: dict, flax_paths: list) -> tuple:
    """Map a numpy-fied torch state dict onto flax paths.

    Args:
      torch_sd: {torch_key: ndarray}, 'module.' already stripped.
      flax_paths: list of tuples — flax param paths (without 'params').
    Returns:
      (flat_params {'a/b/c': ndarray}, used_torch_keys, missing_paths)
    """
    # fp16-trained checkpoints (the reference's default precision is
    # fp16, acr/config.py:96) normalize to fp32 up front: BN folding in
    # half precision loses accuracy and the npz holds fp32. The fold
    # below is numpy float32 in JAX's order, so the arrays are JAX's
    # bit for bit.
    torch_sd = {
        k: (v.astype(np.float32)
            if np.issubdtype(np.asarray(v).dtype, np.floating)
            and np.asarray(v).dtype != np.float32 else v)
        for k, v in torch_sd.items()}

    flat, used, missing = {}, set(), []
    for path in flax_paths:
        name = "/".join(path)
        try:
            base, kind = map_flax_path(path)
        except KeyError:
            missing.append(name)
            continue
        try:
            if kind == "conv_kernel":
                w = torch_sd[base + ".weight"]
                flat[name] = np.transpose(w, (2, 3, 1, 0))
                used.add(base + ".weight")
            elif kind == "conv_bias":
                flat[name] = torch_sd[base + ".bias"]
                used.add(base + ".bias")
            elif kind == "dense_kernel":
                flat[name] = np.transpose(torch_sd[base + ".weight"], (1, 0))
                used.add(base + ".weight")
            elif kind == "dense_bias":
                flat[name] = torch_sd[base + ".bias"]
                used.add(base + ".bias")
            elif kind == "lc_weight":
                w = torch_sd[base + ".weight"]
                flat[name] = w.reshape(w.shape[1], w.shape[2], w.shape[3])
                used.add(base + ".weight")
            elif kind == "bn":
                gamma = torch_sd[base + ".weight"]
                beta = torch_sd[base + ".bias"]
                mean = torch_sd[base + ".running_mean"]
                var = torch_sd[base + ".running_var"]
                scale = gamma / np.sqrt(var + 1e-5)
                leaf = path[-1]
                flat[name] = scale if leaf == "scale" else beta - mean * scale
                used.update(base + s for s in
                            (".weight", ".bias", ".running_mean", ".running_var"))
            else:
                raise KeyError(kind)
        except KeyError:
            missing.append(name)
    return flat, used, missing


def enumerate_flax_paths() -> list:
    """The canonical network's flax parameter paths, in JAX's order."""
    return list(flax_paths())


def carry_parser_heads(torch_sd: dict, flat: dict, used: set) -> None:
    """Carry the merge-mode cross-hand fusion head, which lives on the
    reference's ResultParser (acr/result_parser.py:17-18), so
    prior_mode='merge' checkpoints work even though the demo config
    never enables it (``io.params.split_parser`` takes it back out).
    Mutates ``flat``/``used`` in place."""
    for tkey, name, transform in (
            ("_result_parser.fusion_fc_end.weight", "parser/fusion_fc/kernel",
             lambda w: np.transpose(w, (1, 0))),
            ("_result_parser.fusion_fc_end.bias", "parser/fusion_fc/bias",
             lambda w: w)):
        if tkey in torch_sd:
            flat[name] = transform(torch_sd[tkey])
            used.add(tkey)


def stand_in_state_dict(seed: int = 0) -> dict:
    """A random torch state dict in the reference's key names and layouts
    (float32 numpy): every tensor the conversion reads, drawn from
    ``seed``; conv, linear and LocallyConnected weights and biases at
    0.05 times a normal, BN gamma in [0.1, 0.4) (damped, as in a trained
    network), beta and running_mean 0.05 normal, running_var in
    [0.5, 1.0), and the centre heads' output bias lifted by 0.5 so a
    smoke run detects hands. The stand-in for ``wild.pkl`` where the
    licensed file is absent."""
    rng = np.random.RandomState(seed)
    sd = {}
    for path, shape in flax_paths().items():
        base, kind = map_flax_path(path)
        if kind == "conv_kernel":      # flax (kh,kw,I,O) <- torch (O,I,kh,kw)
            sd[base + ".weight"] = rng.randn(
                shape[3], shape[2], shape[0], shape[1]) * 0.05
        elif kind in ("conv_bias", "dense_bias"):
            sd[base + ".bias"] = rng.randn(*shape) * 0.05
        elif kind == "dense_kernel":   # flax (I,O) <- torch (O,I)
            sd[base + ".weight"] = rng.randn(shape[1], shape[0]) * 0.05
        elif kind == "lc_weight":      # flax (O,C,J) <- torch (1,O,C,J,1,1)
            sd[base + ".weight"] = rng.randn(1, *shape, 1, 1) * 0.05
        elif kind == "bn" and base + ".weight" not in sd:
            c = shape[0]
            sd[base + ".weight"] = rng.rand(c) * 0.3 + 0.1
            sd[base + ".bias"] = rng.randn(c) * 0.05
            sd[base + ".running_mean"] = rng.randn(c) * 0.05
            sd[base + ".running_var"] = rng.rand(c) * 0.5 + 0.5
    for side in "lr":
        base, _ = map_flax_path((f"{side}_center_head", "out", "bias"))
        sd[base + ".bias"] = sd[base + ".bias"] + 0.5
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch_ckpt", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    torch_sd = _to_numpy_state_dict(args.torch_ckpt)
    paths = enumerate_flax_paths()
    flat, used, missing = convert_state_dict(torch_sd, paths)
    carry_parser_heads(torch_sd, flat, used)

    unused = sorted(set(torch_sd) - used)
    print(f"converted {len(flat)}/{len(paths)} params")
    if missing:
        print(f"MISSING ({len(missing)}):", *missing[:20], sep="\n  ",
              file=sys.stderr)
    if unused:
        print(f"unused torch keys ({len(unused)}), e.g.:",
              *unused[:10], sep="\n  ")
    savez_atomic(args.out, flat)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
