"""Mapping from flax parameter paths to reference torch state-dict keys.

The port's copy of ``acr_tpu/io/torch_names.py`` (the port imports
nothing of the JAX package). The reference checkpoint
(``checkpoints/wild.pkl``) is a torch state_dict with ``module.``-prefixed
keys (reference: acr/main.py:59, acr/utils.py:1153-1168). This module
encodes, rule by rule, where each flax parameter of the canonical
network lives in that dict and how its tensor layout differs. It is used
by the port's offline converter (``acr_tpu_torch/tools/convert_checkpoint.py``)
and by tests.

Kinds:
  conv_kernel — torch (O, I, kh, kw)   -> flax (kh, kw, I, O)
  conv_bias   — copied
  bn          — (gamma, beta, running_mean, running_var) folded into
                scale/bias: scale = gamma/sqrt(var + 1e-5),
                bias = beta - mean * scale
  dense_kernel— torch (O, I) -> flax (I, O)
  dense_bias  — copied
  lc_weight   — torch (1, O, C, J, 1, 1) -> flax (O, C, J)
"""

from __future__ import annotations

import re
from typing import Tuple

# our head name -> reference ModuleList index (acr/model.py:185-202)
_HEAD_INDEX = {"params_head": 1, "center_head": 2, "cam_head": 3, "prior_head": 4}
# our side-specific part-module names -> reference list entries (acr/model.py:204-260)
_PART_MAP = {
    ("l", "pose_lc"): "contact_layers.2",
    ("r", "pose_lc"): "contact_layers.3",
    ("l", "shape_fc"): "cam_shape_layers.2",
    ("r", "shape_fc"): "cam_shape_layers.3",
    ("l", "fuse_conv"): "contact_layers.4",
    ("r", "fuse_conv"): "contact_layers.5",
}


def _backbone_base(parts: Tuple[str, ...]) -> str:
    """Torch key base for a backbone-internal module path (sans leaf)."""
    name = parts[0]
    if name == "stem1":
        return {"conv": "backbone.conv1", "bn": "backbone.bn1"}[parts[1]]
    if name == "stem2":
        return {"conv": "backbone.conv2", "bn": "backbone.bn2"}[parts[1]]

    m = re.fullmatch(r"layer1_(\d+)", name)
    if m:
        leaf = parts[1]
        if leaf == "down_conv":
            return f"backbone.layer1.{m.group(1)}.downsample.0"
        if leaf == "down_bn":
            return f"backbone.layer1.{m.group(1)}.downsample.1"
        return f"backbone.layer1.{m.group(1)}.{leaf}"

    m = re.fullmatch(r"transition1_0", name)
    if m:
        return {"conv": "backbone.transition1.0.0",
                "bn": "backbone.transition1.0.1"}[parts[1]]
    m = re.fullmatch(r"transition(\d)_(\d)_(\d)", name)
    if m:
        s, i, k = m.groups()
        idx = {"conv": 0, "bn": 1}[parts[1]]
        return f"backbone.transition{s}.{i}.{k}.{idx}"

    m = re.fullmatch(r"stage(\d)_(\d+)", name)
    if m:
        s, mod = m.groups()
        base = f"backbone.stage{s}.{mod}"
        sub = parts[1]
        bm = re.fullmatch(r"b(\d+)_(\d+)", sub)
        if bm:
            i, k = bm.groups()
            leaf = parts[2]
            if leaf == "down_conv":
                return f"{base}.branches.{i}.{k}.downsample.0"
            if leaf == "down_bn":
                return f"{base}.branches.{i}.{k}.downsample.1"
            return f"{base}.branches.{i}.{k}.{leaf}"
        fm = re.fullmatch(r"fuse_(\d+)_(\d+)_(\d+)", sub)
        if fm:
            i, j, k = fm.groups()
            idx = {"conv": 0, "bn": 1}[parts[2]]
            return f"{base}.fuse_layers.{i}.{j}.{k}.{idx}"
        fm = re.fullmatch(r"fuse_(\d+)_(\d+)", sub)
        if fm:
            i, j = fm.groups()
            idx = {"conv": 0, "bn": 1}[parts[2]]
            return f"{base}.fuse_layers.{i}.{j}.{idx}"
    raise KeyError(f"unmapped backbone path: {parts}")


def _segm_base(parts: Tuple[str, ...]) -> str:
    head = "backbone.hand_segm.segm_head"
    name, leaf = parts[0], parts[1] if len(parts) > 1 else None
    if name == "up1":
        return {"conv": f"{head}.upsampler.up1.conv.double_conv.0",
                "bn": f"{head}.upsampler.up1.conv.double_conv.1"}[leaf]
    if name == "up2":
        return {"conv": f"{head}.upsampler.up1.conv.double_conv.3",
                "bn": f"{head}.upsampler.up1.conv.double_conv.4"}[leaf]
    if name == "out1":
        return {"conv": f"{head}.segm_net.double_conv.0",
                "bn": f"{head}.segm_net.double_conv.1"}[leaf]
    if name == "out_conv2":
        return f"{head}.segm_net.double_conv.3"
    raise KeyError(f"unmapped segm path: {parts}")


def _head_stack_base(side: str, head: str, parts: Tuple[str, ...]) -> str:
    base = f"{side}_final_layers.{_HEAD_INDEX[head]}"
    name = parts[0]
    if name == "trans":
        return {"conv": f"{base}.0.0", "bn": f"{base}.0.1"}[parts[1]]
    m = re.fullmatch(r"blk(\d+)", name)
    if m:
        return f"{base}.1.{m.group(1)}.0.{parts[1]}"
    if name == "out":
        return f"{base}.2"
    raise KeyError(f"unmapped head path: {side}/{head}/{parts}")


_BN_NAME = re.compile(r"(bn\d?|down_bn)")


def map_flax_path(path: Tuple[str, ...]) -> Tuple[str, str]:
    """flax param path (without leading 'params') -> (torch_key_base, kind).

    The leaf element of ``path`` is the flax param name ('kernel',
    'bias', 'scale', 'w'); the returned base omits torch's '.weight' /
    '.bias' suffix (the converter appends per kind).
    """
    *mods, leaf = path
    mods = tuple(mods)
    is_bn = bool(_BN_NAME.fullmatch(mods[-1]))

    # side-specific part-module heads first (no bn inside)
    m = re.fullmatch(r"([lr])_(pose_lc|shape_fc|fuse_conv)", mods[0])
    if m:
        side, what = m.groups()
        base = _PART_MAP[(side, what)]
        if what == "pose_lc":
            return base, "lc_weight"
        if what == "shape_fc":
            return base, ("dense_kernel" if leaf == "kernel" else "dense_bias")
        return base, ("conv_kernel" if leaf == "kernel" else "conv_bias")

    if mods[0] == "backbone":
        base = _backbone_base(mods[1:])
    elif mods[0] == "segm":
        base = _segm_base(mods[1:])
    elif mods[0] == "contact_conv":
        base = {"conv": "contact_layers.1.0", "bn": "contact_layers.1.1"}[mods[1]]
    elif mods[0] == "cam_shape_conv":
        base = "cam_shape_layers.1.0"
    else:
        m = re.fullmatch(r"([lr])_(params_head|center_head|cam_head|prior_head)",
                         mods[0])
        if not m:
            raise KeyError(f"unmapped path: {path}")
        base = _head_stack_base(m.group(1), m.group(2), mods[1:])

    if is_bn:
        return base, "bn"
    if leaf == "kernel":
        return base, "conv_kernel"
    if leaf == "bias":
        return base, "conv_bias"
    raise KeyError(f"unexpected leaf {leaf} at {path}")
