"""Device choice for the port's entry points: the card unless the caller
asks for the CPU, and never a silent fall back to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor and for a meta one: the dry run's meta tensors
    stand for the card, so they take the card's branches."""
    return t.is_cuda or t.is_meta
