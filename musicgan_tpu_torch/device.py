"""The device rule of the package's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` by default; raise rather than run on the CPU unasked."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "musicgan_tpu_torch runs on an NVIDIA GPU by default and none is "
            "available; pass device='cpu' (--device cpu on the command line) "
            "to run the plain PyTorch versions on the CPU"
        )
    return device
