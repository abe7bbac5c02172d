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


def card_line(device="cuda") -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them, for the line
    beside a measured number; ``cpu`` for a CPU device."""
    import subprocess
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    proc = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return proc.stdout.strip().splitlines()[0]
