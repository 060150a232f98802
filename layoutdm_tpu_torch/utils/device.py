"""The device an entry point runs on: the one it was given, or none."""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device and
    CUDA is not available (``device=cpu`` asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; "
            "pass device=cpu to run on the CPU"
        )
    return device
