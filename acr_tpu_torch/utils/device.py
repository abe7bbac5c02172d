"""The torch device of the port's entry points.

They run on the card unless the caller asks for the CPU: ``cuda`` is the
default, and a request for a card where none is visible raises instead of
falling back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises RuntimeError for a CUDA
    device when ``torch.cuda.is_available()`` is False."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA card is visible "
            "(torch.cuda.is_available() is False); pass device='cpu' "
            "(--device cpu) to run the plain PyTorch versions on the CPU")
    return dev
