"""The port's device rule, shared by every public builder and entry point.

Everything runs on the card unless the caller passes ``device="cpu"``:
``device=None`` means the current CUDA device, and raises when there is no
card instead of silently running on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device) -> torch.device:
    """``None`` -> the current CUDA device; raises if there is no card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: repro_torch runs on the card "
                "by default; pass device='cpu' to run the plain torch "
                "versions on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
