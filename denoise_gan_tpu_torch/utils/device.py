"""Explicit device selection.  A CUDA request never falls back to the CPU."""

from __future__ import annotations

import torch


def require_cuda(device: torch.device | str | None = None) -> torch.device:
    """The CUDA device to run on (``cuda`` by default); raises RuntimeError
    when no GPU is present and ValueError for a non-CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device is required, but "
                           "torch.cuda.is_available() is False")
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"expected a CUDA device, got {dev}")
    return dev


def resolve_device(device: torch.device | str) -> torch.device:
    """``torch.device(device)``; a CUDA request without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda(dev)
    return dev
