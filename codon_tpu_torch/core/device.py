"""The device the port's entry points run on.

Entry points default to the card ("cuda") and raise when CUDA is missing;
the CPU runs only when the caller asks for it with device="cpu".
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the card "
                           "unless the caller asks for the CPU "
                           "(device='cpu', --device cpu)")
    return dev
