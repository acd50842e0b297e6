"""The device of the port's entry points: the CUDA card unless the caller
names another. No quiet fallback to the CPU: with no CUDA device and no
explicit ``device`` the entry point raises."""

from __future__ import annotations

import torch


def entry_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means ``cuda``. A CUDA device
    raises when torch sees none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card; pass "
            "device='cpu' to run on the CPU")
    return device
