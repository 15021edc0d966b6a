"""Explicit device selection.  A CUDA request never falls back to the CPU."""

from __future__ import annotations

import contextlib

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
    """``torch.device(device)``, a CUDA device with its index (the current
    one when none is given), so that it compares equal to a tensor's
    ``.device``; a CUDA request without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda(dev)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def no_tf32():
    """f32 convolutions and matmuls at full precision inside the block.
    PyTorch lets cuDNN convolve f32 in TF32 (a 10-bit mantissa) by default;
    XLA's f32 is f32.  bf16 work is unaffected."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
