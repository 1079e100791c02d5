"""Device resolution for the port's entry points.

The port is written for the card: an entry point called without a device runs
on ``cuda`` and raises when there is none. The CPU is used only when a caller
asks for it by name, as the parity tests do. Nothing falls back quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return device
