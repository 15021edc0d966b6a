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


@contextlib.contextmanager
def exact_f32():
    """``no_tf32``, and on the CPU PyTorch's own convolutions in place of
    oneDNN's (mkldnn): oneDNN's f32 convolution backward put pix2pix's
    transposed-conv weight gradients at 256^2 up to 0.2 of a tensor's
    largest value from the JAX package's, PyTorch's own within 6e-4
    (``python tests/training_oracles.py``), at ~1.4-2.2x the CPU time.
    The card's convolutions are unaffected."""
    with no_tf32(), torch.backends.mkldnn.flags(enabled=False):
        yield
