"""Device choice for the port's public entry points.

The device is always explicit.  The default is ``"cuda"``, and asking for
CUDA on a machine without it raises: no entry point drops to the CPU on
its own.  ``"cpu"`` runs the plain PyTorch twin of every kernel and is
used only when a caller passes it (the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
