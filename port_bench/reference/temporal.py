"""The OneEuro filter of the demo's ``-t`` option, frame by frame.

Per detected hand: the global orientation is filtered as a rotation
matrix and turned back into axis-angle; the 45 articulation values and
the 10 betas are filtered directly, their derivative taken against the
previous filtered value (the reference app's aliased buffers). Cut-offs:
orientation and articulation ``min_cutoff`` = the smoothing coefficient,
beta 0.7; betas 0.6 and 0.7; derivative cut-off 1; 30 frames/s. A hand
that is not detected passes through and leaves its filter untouched.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference.parse import axis_angle_to_rotmat, rotmat_to_axis_angle

FREQ = 30.0


def _alpha(cutoff):
    return 1.0 / (1.0 + FREQ / (2.0 * math.pi * cutoff))


class OneEuro:
    """One filtered quantity; ``from_output`` takes the derivative
    against the previous output."""

    def __init__(self, min_cutoff: float, beta: float, from_output: bool):
        self.min_cutoff, self.beta, self.from_output = min_cutoff, beta, from_output
        self.x = self.y = self.dx = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.y is None:
            self.x, self.y, self.dx = x, x, torch.zeros_like(x)
            return x
        base = self.y if self.from_output else self.x
        dx = (x - base) * FREQ
        a_d = _alpha(1.0)
        self.dx = a_d * dx + (1 - a_d) * self.dx
        a = _alpha(self.min_cutoff + self.beta * self.dx.abs())
        self.y = a * x + (1 - a) * self.y
        self.x = x
        return self.y


class HandFilter:
    def __init__(self, coeff: float):
        self.orient = OneEuro(coeff, 0.7, False)
        self.pose = OneEuro(coeff, 0.7, True)
        self.betas = OneEuro(0.6, 0.7, True)

    def __call__(self, poses: torch.Tensor, betas: torch.Tensor):
        rot = self.orient(axis_angle_to_rotmat(poses[:3]))
        orient = rotmat_to_axis_angle(rot)
        return torch.cat([orient, self.pose(poses[3:])]), self.betas(betas)


def smooth(poses: torch.Tensor, betas: torch.Tensor, detected: torch.Tensor,
           coeff: float = 4.0):
    """A sequence: poses (T, 2, 48), betas (T, 2, 10), detected (T, 2) ->
    the filtered poses and betas, both hands' filters fresh at frame 0."""
    filters = [HandFilter(coeff), HandFilter(coeff)]
    out_p, out_b = poses.clone(), betas.clone()
    det = detected.cpu().tolist()
    for t in range(poses.shape[0]):
        for h in range(2):
            if det[t][h]:
                out_p[t, h], out_b[t, h] = filters[h](poses[t, h], betas[t, h])
    return out_p, out_b
