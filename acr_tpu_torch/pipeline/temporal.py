"""OneEuro temporal filter as a function of (state, x) -> (state, y).

Counterpart of ``acr_tpu/pipeline/temporal.py``, with the same
semantics (reference: acr/main.py:50-53,69-83; acr/utils.py:1472-1527):

* the global orientation is smoothed in rotation-matrix space and
  converted back to axis-angle;
* articulation (45) and betas (10) are smoothed directly, with the
  derivative taken against the previous *output* (``dx_from_output``):
  the reference's aliasing of its raw-value buffer, kept on purpose;
* coefficients: poses/orient (mincutoff=smooth_coeff, beta=0.7), betas
  (0.6, 0.7); dcutoff 1.0; freq 30;
* an undetected hand leaves its filter state untouched.

The state is a tree of tensors on the pipeline's device, and
``initialized`` and ``detected`` are tensors too: every update selects
with ``torch.where`` and reads nothing back to the host, so a stream
step stays free of synchronisation.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from acr_tpu_torch.ops.rotations import axis_angle_to_rotmat, rotmat_to_axis_angle
from acr_tpu_torch.utils.device import resolve_device


class ChannelState(NamedTuple):
    """LowPass pair (value + derivative) for one filtered tensor."""
    x_prev: torch.Tensor        # previous raw input
    y_prev: torch.Tensor        # previous filtered output
    dy_prev: torch.Tensor       # previous filtered derivative
    initialized: torch.Tensor   # () bool


def init_channel(shape, device="cuda") -> ChannelState:
    """A fresh channel on ``device`` (the card unless ``device="cpu"``;
    raises without a card)."""
    device = resolve_device(device)
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return ChannelState(z, z, z, torch.zeros((), dtype=torch.bool,
                                             device=device))


def _alpha(cutoff, freq):
    # reference compute_alpha (utils.py:1509-1512): 1 / (1 + tau/te)
    tau = 1.0 / (2.0 * math.pi * cutoff)
    te = 1.0 / freq
    return 1.0 / (1.0 + tau / te)


def oneeuro_step(state: ChannelState, x: torch.Tensor, mincutoff: float,
                 beta: float, dcutoff: float = 1.0, freq: float = 30.0,
                 dx_from_output: bool = False
                 ) -> Tuple[ChannelState, torch.Tensor]:
    """One filter update (elementwise over the tensor).

    ``dx_from_output=True`` takes the derivative against the previous
    smoothed output instead of the previous raw input (the reference
    app's aliased articulation/betas channels). Identical through the
    first two calls (y_1 == x_1).
    """
    first = ~state.initialized
    base = state.y_prev if dx_from_output else state.x_prev
    dx = torch.where(first, torch.zeros_like(x), (x - base) * freq)
    a_d = _alpha(dcutoff, freq)
    edx = torch.where(first, dx, a_d * dx + (1.0 - a_d) * state.dy_prev)
    cutoff = mincutoff + beta * torch.abs(edx)
    a = _alpha(cutoff, freq)
    y = torch.where(first, x, a * x + (1.0 - a) * state.y_prev)
    return ChannelState(x, y, edx, torch.ones_like(state.initialized)), y


class HandFilterState(NamedTuple):
    """OneEuro state for one hand slot (orient in matrix space)."""
    orient: ChannelState       # (3, 3)
    pose: ChannelState         # (45,)
    betas: ChannelState        # (10,)


def init_hand_filter(device="cuda") -> HandFilterState:
    return HandFilterState(init_channel((3, 3), device),
                           init_channel((45,), device),
                           init_channel((10,), device))


def _select(detected: torch.Tensor, new, old):
    """``torch.where(detected, new, old)`` over every leaf of a state."""
    if isinstance(new, torch.Tensor):
        return torch.where(detected, new, old)
    return type(new)(*(_select(detected, a, b) for a, b in zip(new, old)))


def smooth_hand(state: HandFilterState, poses48: torch.Tensor,
                betas10: torch.Tensor, detected: torch.Tensor,
                smooth_coeff: float = 4.0
                ) -> Tuple[HandFilterState, torch.Tensor, torch.Tensor]:
    """Smooth one hand's parameters; no-op (state preserved) if not detected."""
    rot = axis_angle_to_rotmat(poses48[:3])
    s_orient, rot_s = oneeuro_step(state.orient, rot, smooth_coeff, 0.7)
    orient_s = rotmat_to_axis_angle(rot_s[None])[0]
    s_pose, pose_s = oneeuro_step(state.pose, poses48[3:], smooth_coeff, 0.7,
                                  dx_from_output=True)
    s_betas, betas_s = oneeuro_step(state.betas, betas10, 0.6, 0.7,
                                    dx_from_output=True)
    out_state = _select(detected, HandFilterState(s_orient, s_pose, s_betas),
                        state)
    poses_out = torch.where(detected, torch.cat([orient_s, pose_s]), poses48)
    betas_out = torch.where(detected, betas_s, betas10)
    return out_state, poses_out, betas_out


class TwoHandFilterState(NamedTuple):
    left: HandFilterState
    right: HandFilterState


def init_two_hand_filter(device="cuda") -> TwoHandFilterState:
    return TwoHandFilterState(init_hand_filter(device), init_hand_filter(device))


def smooth_two_hands(state: TwoHandFilterState, poses: torch.Tensor,
                     betas: torch.Tensor, detection_flag: torch.Tensor,
                     smooth_coeff: float = 4.0):
    """poses (2,48), betas (2,10), detection_flag (2,) -> smoothed pair."""
    sl, pl, bl = smooth_hand(state.left, poses[0], betas[0],
                             detection_flag[0], smooth_coeff)
    sr, pr, br = smooth_hand(state.right, poses[1], betas[1],
                             detection_flag[1], smooth_coeff)
    return (TwoHandFilterState(sl, sr),
            torch.stack([pl, pr]), torch.stack([bl, br]))


def smooth_sequence(state: TwoHandFilterState, poses: torch.Tensor,
                    betas: torch.Tensor, detection_flag: torch.Tensor,
                    smooth_coeff: float = 4.0):
    """Filter a frame sequence: ``smooth_two_hands`` frame by frame.

    poses (T,2,48), betas (T,2,10), detection_flag (T,2) ->
    (final_state, smoothed poses (T,2,48), smoothed betas (T,2,10)).
    """
    ps, bs = [], []
    for t in range(poses.shape[0]):
        state, p, b = smooth_two_hands(state, poses[t], betas[t],
                                       detection_flag[t], smooth_coeff)
        ps.append(p)
        bs.append(b)
    return state, torch.stack(ps), torch.stack(bs)
