"""Fused SRGAN tail: up1 -> up2 -> 1x1 out_conv -> tanh -> crop-stitch -> u8.

Counterpart of denoise_gan_tpu/ops/pallas/tail_srgan.py.  The SRGAN tail
has CIN=64 body channels, up1 and up2 of 64 -> 256 channels and a 1x1
output conv; its geometry, modes, calibration (Q8_MARGIN) and epilogue are
the FSRGAN tail's, so the weight preparation and the twin's arithmetic are
ops/tail.py's, which work for any CIN:

* ``prepare_tail64`` -> :class:`~denoise_gan_tpu_torch.ops.tail.TailWeights`
  in the layouts of ``csrc/tail_srgan.cu``: bf16 w1, w2 (576, 256) and w3
  (64, 3); w8a8 w2 (144, 256, 4) and w3 (3, 64) int8, per conv output
  channel (tail_srgan.py:114-126), with activation scales calibrated at
  Q8_MARGIN on the plain f32 tail;
* ``fused_tail64_u8``, the wrapper of the CUDA kernel;
* ``fused_tail64_u8_reference``, its plain PyTorch twin.  The wrapper runs
  it for a tensor on the CPU; on a CUDA tensor it launches the kernel or
  raises.

A 1x1 output conv has no tap that reaches a neighbouring 4-column group,
so R is quantised from f32 throughout (tail_srgan.py:283, :294-295).
"""

from __future__ import annotations

import torch

from denoise_gan_tpu_torch.models.srgan import SRGANTail
from denoise_gan_tpu_torch.ops.tail import (
    TailWeights, _check, _launch, _twin_frame, prepare_tail,
)

CIN = 64         # SRGAN body output channels

# Plain integers: the kernel's launches and the twin's calls.
launch_counts = {"fused_tail64_u8": 0, "fused_tail64_u8_reference": 0}


def prepare_tail64(tail: SRGANTail, q8_calib: torch.Tensor | None = None,
                   device: torch.device | str | None = None) -> TailWeights:
    """TailWeights of a 4x SRGANTail (two stages after a 64-channel body)
    for csrc/tail_srgan.cu; w8a8 when q8_calib (sample body-output tiles,
    NHWC) is given, else bf16."""
    if not isinstance(tail, SRGANTail) or tail.stages != 2 or \
            tail.up1.Conv_0.weight.shape[1] != CIN:
        raise ValueError("the fused SRGAN tail takes the 4x tail of a "
                         f"{CIN}-channel body")
    return prepare_tail(tail, q8_calib=q8_calib, device=device)


def fused_tail64_u8_reference(h: torch.Tensor, tw: TailWeights, ny: int,
                              nx: int, height: int, width: int,
                              bgr: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: per tile up1 (summed in the
    kernel's order), up2 and the 1x1 conv at full f32 precision, tanh,
    crop-stitch and u8.  h: (ny*nx, cr+4, 124, 64) bf16 body output.
    Returns the (4*height, 4*width, 3) uint8 frame.  w8a8 sums integers in
    f32, exactly (|sum| <= 127*127*576 < 2**24), so it matches the kernel
    bit for bit but for tanh; bf16 differs where the f32 sums of up2 and the
    output conv round apart."""
    cr = _check(h, tw, CIN, ny, nx, height, width)
    launch_counts["fused_tail64_u8_reference"] += 1
    return _twin_frame(h, tw, ny, nx, cr, height, width, bgr)


def fused_tail64_u8(h: torch.Tensor, tw: TailWeights, ny: int, nx: int,
                    height: int, width: int, bgr: bool = False
                    ) -> torch.Tensor:
    """The fused SRGAN tail as one CUDA kernel launch (csrc/tail_srgan.cu);
    same contract as :func:`fused_tail64_u8_reference`, which runs instead
    when h lies on the CPU.  Any other device launches the kernel or
    raises."""
    cr = _check(h, tw, CIN, ny, nx, height, width)
    if h.device.type == "cpu":
        return fused_tail64_u8_reference(h, tw, ny, nx, height, width, bgr)
    out = _launch("dgt_tail64_u8", h, tw, nx, cr, height, width, bgr)
    launch_counts["fused_tail64_u8"] += 1
    return out
