"""Where the port's entry points place their work."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> the CUDA card, raising when there is none; the CPU only when
    the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
