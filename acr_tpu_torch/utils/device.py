"""The torch device of the port's entry points.

They run on the card unless the caller asks for the CPU: ``cuda`` is the
default, and a request for a card where none is visible raises instead of
falling back to the CPU. ``PEAKS`` holds the cards' published peak rates,
keyed by the name ``nvidia-smi`` gives (``card_line``).
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


# Published peaks, dense (no sparsity), at the full power limit: NVIDIA's
# H100 SXM5 data sheet. bf16 is the tensor cores' rate; fp32 is the rate
# outside them (the port keeps TF32 off), counting an FFMA as two
# operations; bytes_s is HBM3's.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.4e12, "fp32": 66.9e12,
                              "bytes_s": 3.35e12},
}


def card_peaks(device="cuda") -> dict:
    """``PEAKS`` of the card behind ``device``, by its ``nvidia-smi``
    name; raises ValueError for a card the table does not know (or the
    CPU)."""
    name = card_line(device).split(",")[0].strip()
    if name not in PEAKS:
        raise ValueError(f"no peak rates for {name!r}: add the card's data "
                         "sheet figures to acr_tpu_torch.utils.device.PEAKS")
    return PEAKS[name]
