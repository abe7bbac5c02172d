"""``correct``: the harness's side of the judge.

The architecture's module (``archs/<architecture>.py``) holds the frozen
reference over a sequence and the numbers it reads against the program's
outputs (``new_numbers``, ``judge_sequence``). The harness holds what
every architecture shares: ``fp32_math`` (TF32 off in the reference, on
only for a control), the block of frames the reference computes at once
(``BLOCK``), the levels by which a delivered frame's value may differ
from the reference's composite (``LEVELS``), and ``verdict``: the
numbers against the configuration file's ``limits``.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

LEVELS = 8
BLOCK = 16


@contextlib.contextmanager
def fp32_math(tf32: bool = False):
    """fp32 products and convolutions, TF32 on only for a control."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            judged: int):
    """(correct, [[name, number, limit], ...]) over the numbers that the
    configuration gives a limit; a run that finished no frame to judge
    is not correct."""
    checks = [[k, numbers[k], float(limits[k])] for k in numbers if k in limits]
    return judged > 0 and all(v <= lim for _, v, lim in checks), checks
