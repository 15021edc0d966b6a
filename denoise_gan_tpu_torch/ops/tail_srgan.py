"""Fused SRGAN tail: up1 -> up2 -> 1x1 out_conv -> tanh -> crop-stitch -> u8
(or a bf16 canvas).

Counterpart of denoise_gan_tpu/ops/pallas/tail_srgan.py.  The SRGAN tail
has CIN=64 body channels, up1 and up2 of 64 -> 256 channels and a 1x1
output conv; its geometry, modes (bf16, w8a8, qh8), calibration
(Q8_MARGIN) and epilogues are the FSRGAN tail's, so the weight preparation,
``quantize_h`` and the twins' arithmetic are ops/tail.py's, which work for
any CIN:

* ``prepare_tail64`` -> :class:`~denoise_gan_tpu_torch.ops.tail.TailWeights`
  in the layouts of ``csrc/tail_srgan.cu``: bf16 w1, w2 (576, 256) and w3
  (64, 3); int8 w2 (144, 256, 4) and w3 (3, 64), per conv output channel
  (tail_srgan.py:114-126), with activation scales calibrated at Q8_MARGIN
  on the plain f32 tail; qh8 also int8 w1 (144, 256, 4) with the h step
  sizes folded in (tail_srgan.py:129-139);
* ``fused_tail64_u8`` and ``fused_tail64_canvas``, the wrappers of the
  CUDA kernel;
* ``fused_tail64_u8_reference`` and ``fused_tail64_canvas_reference``,
  their plain PyTorch twins.  A wrapper runs its twin for a tensor on the
  CPU; on a CUDA tensor it launches the kernel or raises.

A 1x1 output conv has no tap that reaches a neighbouring 4-column group,
so R is quantised from f32 throughout (tail_srgan.py:283, :294-295).

The kernel sums on the tensor cores: int8 x int8 -> int32 (qh8's up1, up2
in w8a8 and qh8), exact in any order, and bf16 x bf16 -> f32 (up1 in bf16
and w8a8, up2 in bf16) in its own order.  The twins sum up1 in K1's order
(ops/tail.py::_up1_sum); the kernel sums again, in that order, each u1
value whose int8 step (w8a8) or bf16 rounding (bf16) its tensor-core sum
leaves uncertain: in w8a8 within ops/tail.py::up1_err, a bound, so its u1
is the twin's; in bf16, whose contract is a statistical bound, within the
measured margin 2**-18 (ops/tail.py::kernel_params reports both).
``dyadic_up1_`` and ``dyadic_h`` draw inputs on which every f32 partial
sum of up1 is exact, so that any order gives the twin's u1; ops/tail.py::
one_sign_up1_ and one_sign_h those where errors add up.
"""

from __future__ import annotations

import torch

from denoise_gan_tpu_torch.models.srgan import SRGANTail
from denoise_gan_tpu_torch.ops.tail import (
    TailWeights, mode_counts, prepare_tail, run_kernel, run_twin,
)

CIN = 64         # SRGAN body output channels

# Plain integers: the kernel's launches and the twins' calls, per mode.
launch_counts = mode_counts("fused_tail64_u8", "fused_tail64_u8_reference",
                            "fused_tail64_canvas",
                            "fused_tail64_canvas_reference")


def prepare_tail64(tail: SRGANTail, q8_calib: torch.Tensor | None = None,
                   device: torch.device | str | None = None,
                   qh8: bool = False) -> TailWeights:
    """TailWeights of a 4x SRGANTail (two stages after a 64-channel body)
    for csrc/tail_srgan.cu; w8a8 when q8_calib (sample body-output tiles,
    NHWC) is given, qh8 when `qh8` too, else bf16."""
    if not isinstance(tail, SRGANTail) or tail.stages != 2 or \
            tail.up1.Conv_0.weight.shape[1] != CIN:
        raise ValueError("the fused SRGAN tail takes the 4x tail of a "
                         f"{CIN}-channel body")
    return prepare_tail(tail, q8_calib=q8_calib, device=device, qh8=qh8)


def fused_tail64_u8_reference(h: torch.Tensor, tw: TailWeights, ny: int,
                              nx: int, height: int, width: int,
                              bgr: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: per tile up1 (summed in K1's
    order, ops/tail.py::_up1_sum), up2 and the 1x1 conv at full f32
    precision, tanh, crop-stitch and u8.  h: (ny*nx, cr+4, 124, 64) body
    output, bf16 (int8 for qh8 weights).  Returns the (4*height, 4*width, 3)
    uint8 frame.  The int8 sums are integers, exact in f32 (|sum| <=
    127*127*576 < 2**24), and the kernel's u1 is the twin's (it sums again
    in this order where its own sums leave u1's rounding uncertain), so w8a8
    and qh8 match the kernel bit for bit but for tanh; bf16 differs where
    the f32 sums of up2 and the output conv round apart."""
    return run_twin("fused_tail64_u8_reference", launch_counts, CIN, h, tw,
                    ny, nx, height, width, bgr, canvas=False)


def fused_tail64_canvas_reference(h: torch.Tensor, tw: TailWeights, ny: int,
                                  nx: int, height: int, width: int,
                                  bgr: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the canvas epilogue: as
    :func:`fused_tail64_u8_reference`, returning the (4*height, 4*width, 3)
    bf16 frame of tanh, RGB; bgr=True raises ValueError."""
    return run_twin("fused_tail64_canvas_reference", launch_counts, CIN, h,
                    tw, ny, nx, height, width, bgr, canvas=True)


def fused_tail64_u8(h: torch.Tensor, tw: TailWeights, ny: int, nx: int,
                    height: int, width: int, bgr: bool = False
                    ) -> torch.Tensor:
    """The fused SRGAN tail as one CUDA kernel launch (csrc/tail_srgan.cu);
    same contract as :func:`fused_tail64_u8_reference`, which runs instead
    when h lies on the CPU.  Any other device launches the kernel or
    raises."""
    return run_kernel("fused_tail64_u8", launch_counts, "dgt_tail64",
                      fused_tail64_u8_reference, CIN, h, tw, ny, nx, height,
                      width, bgr, canvas=False)


def fused_tail64_canvas(h: torch.Tensor, tw: TailWeights, ny: int, nx: int,
                        height: int, width: int, bgr: bool = False
                        ) -> torch.Tensor:
    """The fused SRGAN tail with the canvas epilogue as one CUDA kernel
    launch; same contract as :func:`fused_tail64_canvas_reference`, which
    runs instead when h lies on the CPU."""
    return run_kernel("fused_tail64_canvas", launch_counts, "dgt_tail64",
                      fused_tail64_canvas_reference, CIN, h, tw, ny, nx,
                      height, width, bgr, canvas=True)


# ---------------------------------------------------------------------------
# inputs on which every f32 partial sum of up1 is exact

# h on k / H_DEN and W1 on j / W1_DEN, |k|, |j| <= GRID_MAX, b1 on multiples
# of 2**-9: every product is a multiple of 2**-9 and every partial sum of
# up1 below 576 * 2 * 0.25 = 288 < 2**9, so 18 significant bits hold it.
H_DEN, W1_DEN, GRID_MAX = 8, 64, 16
B1_STEP = 2.0 ** -9


@torch.no_grad()
def dyadic_up1_(tail: SRGANTail, generator: torch.Generator) -> SRGANTail:
    """Redraw the tail's up1 weight on the grid j / W1_DEN (|j| <=
    GRID_MAX) and its bias on multiples of B1_STEP (|b1| <= 64 steps), in
    place; returns the tail."""
    conv = tail.up1.Conv_0
    for p, den, top in ((conv.weight, W1_DEN, GRID_MAX),
                        (conv.bias, 1 / B1_STEP, 64)):
        k = torch.randint(-top, top + 1, p.shape, generator=generator)
        p.copy_(k.float() / den)
    return tail


def dyadic_h(shape: tuple[int, ...], generator: torch.Generator,
             device: torch.device | str = "cpu") -> torch.Tensor:
    """bf16 body-output tiles on the grid k / H_DEN, |k| <= GRID_MAX."""
    k = torch.randint(-GRID_MAX, GRID_MAX + 1, shape, generator=generator)
    return (k.float() / H_DEN).to(device, torch.bfloat16)
