"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device to run on: CUDA unless the caller names another. Asking
    for CUDA where there is none raises; nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but is not available; pass device='cpu' to run on the host"
        )
    return dev
