"""Fused FSRGAN tail: up1 -> up2 -> out_conv -> tanh -> crop-stitch -> u8.

Counterpart of denoise_gan_tpu/ops/pallas/tail.py.  Three pieces:

* weight preparation (``prep_weights``, ``prep_weights_q8``,
  ``calibrate_tail_scales``, ``prepare_tail``) -> :class:`TailWeights`;
* ``fused_tail_u8``, the wrapper of the CUDA kernel in ``csrc/tail.cu``;
* ``fused_tail_u8_reference``, the kernel's plain PyTorch twin: the same
  function with quantisation and rounding at the same points.  The wrapper
  runs it for a tensor on the CPU; on a CUDA tensor it launches the kernel
  or raises.

The weight preparation, the twin's arithmetic and the launch are written
for any body width (CIN) and output-conv size; ops/tail_srgan.py reuses
them for the SRGAN tail (CIN=64, 1x1 output conv).

Geometry (as the JAX engine): tiles are (core_rows + 4, T=124) coarse
pixels with CIN channels; the core of a tile is coarse rows [2, 2+cr) and
cols [2, 122), i.e. fine [8, 8+4cr) x [8, 488), and the cores of an
(ny, nx) grid tile the frame.  Every core pixel depends only on its own tile,
so no SAME padding reaches the output.

Modes (chosen by the weights):

* bf16: bf16 operands, f32 sums; up1 and up2 outputs are rounded to bf16
  before the next conv.
* w8a8: up1 as in bf16; up2 and the output conv are int8 x int8 -> int32
  with per-output-channel weight scales and static activation scales (u1
  and R quantised from f32, round half to even, clip to +-127), dequantised
  as ``int32 * (s_w * s_act) + bias``.  As in the JAX kernel
  (tail.py:439-453), a 3x3 output conv's taps that reach the neighbouring
  4-column group (output fine column 4j+f reading column 4j-1 or 4j+4)
  read R quantised from its bf16 copy instead.

Epilogue: tanh is rounded to bf16, then u8 = trunc(clip((v+1)*127.5 + 0.5,
0, 255)), RGB or BGR.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from denoise_gan_tpu_torch.ops.image import depth_to_space_nchw
from denoise_gan_tpu_torch.utils.device import require_cuda

T = 124          # coarse tile width
CORE = 120       # tile core width = column stride
CIN = 32         # FSRGAN body output channels
# Headroom over the calibration max (denoise_gan_tpu/ops/pallas/tail.py:625)
Q8_MARGIN = 1.25

# Plain integers: the kernel's launches and the twin's calls.
launch_counts = {"fused_tail_u8": 0, "fused_tail_u8_reference": 0}


@dataclass(frozen=True)
class TailWeights:
    """Tail weights in the kernels' layouts, on one device, for a body of C
    channels (C = 32: FSRGAN, 3x3 output conv; C = 64: SRGAN, 1x1).  Conv
    rows are k = (dy*kw + dx)*C + cin (HWIO flattened); conv output channel
    q = (a*2 + b)*C + t goes to depth_to_space phase (a, b), channel t.
    K3 = kh*kw*C is the output conv's depth.

    bf16 mode: w2 (9C, 4C) and w3 (K3, 3) bf16.
    w8a8 mode: w2 (9C/4, 4C, 4) int8 (4 consecutive k of one q per int32
    word), w3 (3, K3) int8, and the dequant scales s2 (4C,), s3 (3,) f32
    (weight scale x activation scale); inv_su1/inv_sr quantise u1 and R."""

    w1: torch.Tensor                 # (9C, 4C) bf16
    b1: torch.Tensor                 # (4C,) f32
    a1: torch.Tensor                 # (C,) f32
    w2: torch.Tensor
    b2: torch.Tensor                 # (4C,) f32
    a2: torch.Tensor                 # (C,) f32
    w3: torch.Tensor
    b3: torch.Tensor                 # (3,) f32
    s2: torch.Tensor | None = None
    s3: torch.Tensor | None = None
    inv_su1: float = 0.0
    inv_sr: float = 0.0

    @property
    def q8(self) -> bool:
        return self.s2 is not None

    @property
    def device(self) -> torch.device:
        return self.w1.device

    @property
    def cin(self) -> int:
        return self.a1.shape[0]

    def conv_weights(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(w1, w2, w3) as OIHW f32 (bf16 values, or int8 integers)."""
        c = self.cin
        w2 = self.w2.permute(0, 2, 1).reshape(9 * c, 4 * c) if self.q8 \
            else self.w2
        w3 = self.w3.t() if self.q8 else self.w3
        k3 = math.isqrt(w3.shape[0] // c)
        return tuple(w.float().reshape(k, k, c, -1).permute(3, 2, 0, 1)
                     for w, k in ((self.w1, 3), (w2, 3), (w3, k3)))


# ---------------------------------------------------------------------------
# weight preparation

def prep_weights(tail: nn.Module) -> dict[str, np.ndarray]:
    """f32 HWIO arrays of the conv weights, biases and slopes of a tail
    with ``up1``/``up2`` (PixelShuffleUp) and ``out_conv`` (FSRGANTail,
    SRGANTail)."""
    def hwio(conv):
        return conv.weight.detach().cpu().numpy().transpose(2, 3, 1, 0)

    def vec(p):
        return p.detach().cpu().numpy().astype(np.float32)

    return dict(
        W1=hwio(tail.up1.Conv_0), b1=vec(tail.up1.Conv_0.bias),
        a1=vec(tail.up1.PReLU_0.alpha),
        W2=hwio(tail.up2.Conv_0), b2=vec(tail.up2.Conv_0.bias),
        a2=vec(tail.up2.PReLU_0.alpha),
        W3=hwio(tail.out_conv), b3=vec(tail.out_conv.bias),
    )


def _quantize_per_output(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 per output channel (last axis) as
    ``prep_weights_q8`` (tail.py:150-164) does per packed column."""
    s = np.abs(w).max(axis=(0, 1, 2)) / 127.0 + 1e-12
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def prep_weights_q8(weights: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Add int8 forms of up2 and the output conv: ``W2q``/``W3q`` (HWIO)
    with weight scales ``s2w`` (4C,) and ``s3w`` (3,).  A packed column of
    the JAX kernels holds all taps x C inputs of one conv output channel,
    so its scales are per conv output channel."""
    out = dict(weights)
    out["W2q"], out["s2w"] = _quantize_per_output(weights["W2"])
    out["W3q"], out["s3w"] = _quantize_per_output(weights["W3"])
    return out


@contextlib.contextmanager
def _exact_f32():
    """Run f32 convolutions at full precision.  cuDNN convolves f32 in
    TF32 by default, and may pick Winograd or FFT algorithms, which would
    break the exact integer sums of the w8a8 twin; inside this block cuDNN
    is off (PyTorch's im2col + GEMM path) and TF32 is off for matmuls."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, w, padding=w.shape[-1] // 2)


def _prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha.view(1, -1, 1, 1) * x)


def _bias(b: torch.Tensor) -> torch.Tensor:
    return b.view(1, -1, 1, 1)


@torch.no_grad()
def calibrate_tail_scales(tail: nn.Module, h_sample: torch.Tensor,
                          margin: float = 1.0) -> tuple[float, float]:
    """Static int8 step sizes (su1, sr) for the w8a8 tail: max|u1| and
    max|R| of the plain f32 up1/up2 on sample body-output tiles (NHWC),
    times margin / 127, floored at 1e-9 (tail.py:216-247)."""
    p = {k: torch.from_numpy(v).to(h_sample.device)
         for k, v in prep_weights(tail).items()}
    w1, w2 = (p[k].permute(3, 2, 0, 1) for k in ("W1", "W2"))
    with _exact_f32():
        x = h_sample.float().permute(0, 3, 1, 2)
        u1 = _prelu(depth_to_space_nchw(_conv(x, w1) + _bias(p["b1"]), 2),
                    p["a1"])
        r = _prelu(depth_to_space_nchw(_conv(u1, w2) + _bias(p["b2"]), 2),
                   p["a2"])
        su1 = float(u1.abs().max()) * margin / 127.0
        sr = float(r.abs().max()) * margin / 127.0
    return max(su1, 1e-9), max(sr, 1e-9)


def prepare_tail(tail: nn.Module, q8_calib: torch.Tensor | None = None,
                 device: torch.device | str | None = None) -> TailWeights:
    """TailWeights for `tail` (FSRGANTail or SRGANTail) on `device`
    (default: the tail's).  With q8_calib (sample body-output tiles, NHWC)
    the tail runs w8a8 with activation scales calibrated on it at
    Q8_MARGIN; else bf16."""
    dev = torch.device(device) if device is not None else \
        tail.out_conv.weight.device
    w = prep_weights(tail)
    k, n = w["W2"].shape[2] * 9, w["W2"].shape[3]       # 9C, 4C

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    common = dict(w1=t(w["W1"].reshape(k, n), torch.bfloat16),
                  b1=t(w["b1"]), a1=t(w["a1"]), b2=t(w["b2"]),
                  a2=t(w["a2"]), b3=t(w["b3"]))
    if q8_calib is None:
        return TailWeights(w2=t(w["W2"].reshape(k, n), torch.bfloat16),
                           w3=t(w["W3"].reshape(-1, 3), torch.bfloat16),
                           **common)
    w = prep_weights_q8(w)
    su1, sr = calibrate_tail_scales(tail, q8_calib, margin=Q8_MARGIN)
    w2q = w["W2q"].reshape(k // 4, 4, n).transpose(0, 2, 1)
    return TailWeights(
        w2=t(w2q, torch.int8), w3=t(w["W3q"].reshape(-1, 3).T, torch.int8),
        s2=t(w["s2w"] * np.float32(su1)), s3=t(w["s3w"] * np.float32(sr)),
        inv_su1=float(np.float32(1.0 / su1)),
        inv_sr=float(np.float32(1.0 / sr)), **common)


# ---------------------------------------------------------------------------
# the twin

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _quant(x: torch.Tensor, inv: float) -> torch.Tensor:
    return torch.clamp(torch.round(x * inv), -127.0, 127.0)


def _to_u8(v: torch.Tensor) -> torch.Tensor:
    u = (_bf16(v) + 1.0) * 127.5 + 0.5
    return torch.clamp(u, 0.0, 255.0).to(torch.uint8)


def _up1_sum(x: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """up1's 3x3 SAME conv, summed in the kernel's order: one product at a
    time, tap-major then input channel, in f32.  The bf16 x bf16 products
    are exact in f32, so the sums are bit for bit the kernel's, and w8a8
    quantises the same u1.  (A conv library sums in its own order; that
    moves a few u1 values across an int8 rounding boundary, and each such
    flip moves nearby output bytes by up to 2 levels.)"""
    n, c, hh, ww = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    acc = x.new_zeros((n, w1.shape[0], hh, ww))
    for dy in range(3):
        for dx in range(3):
            for ci in range(c):
                acc.addcmul_(xp[:, ci:ci + 1, dy:dy + hh, dx:dx + ww],
                             w1[:, ci, dy, dx].view(1, -1, 1, 1))
    return acc


def _edge_taps(d: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """What the JAX kernel adds to a 3x3 output conv's integer sums
    (tail.py:439-453): the tap dx=0 of output column 4j reads column 4j-1,
    and the tap dx=2 of column 4j+3 reads 4j+4, each from R quantised from
    its bf16 copy.  d = that quantisation minus R's from f32 (both integers,
    so the correction is exact in f32)."""
    dx = torch.arange(3, device=w3.device)
    left, right = _conv(d, w3 * (dx == 0)), _conv(d, w3 * (dx == 2))
    f = torch.arange(d.shape[-1], device=d.device) % 4
    return torch.where(f == 0, left, 0.0) + torch.where(f == 3, right, 0.0)


def _tail_tiles_u8(h: torch.Tensor, tw: TailWeights) -> torch.Tensor:
    """(n, TR, T, C) bf16 tiles -> (n, 4TR, 4T, 3) uint8, per-tile SAME.
    Columns are tile-local, so column 4j starts a 4-column group."""
    w1, w2, w3 = tw.conv_weights()
    x = h.float().permute(0, 3, 1, 2)
    u1 = _prelu(depth_to_space_nchw(_up1_sum(x, w1) + _bias(tw.b1), 2),
                tw.a1)
    if tw.q8:
        c2 = _conv(_quant(u1, tw.inv_su1), w2) * _bias(tw.s2) + _bias(tw.b2)
        r = _prelu(depth_to_space_nchw(c2, 2), tw.a2)
        rq = _quant(r, tw.inv_sr)
        acc = _conv(rq, w3)
        if w3.shape[-1] == 3:
            acc = acc + _edge_taps(_quant(_bf16(r), tw.inv_sr) - rq, w3)
        y = acc * _bias(tw.s3) + _bias(tw.b3)
    else:
        c2 = _conv(_bf16(u1), w2) + _bias(tw.b2)
        r = _prelu(depth_to_space_nchw(c2, 2), tw.a2)
        y = _conv(_bf16(r), w3) + _bias(tw.b3)
    return _to_u8(torch.tanh(y)).permute(0, 2, 3, 1)


def _check(h: torch.Tensor, tw: TailWeights, cin: int, ny: int, nx: int,
           height: int, width: int) -> int:
    """Validate a tail's inputs for a body of `cin` channels; returns
    core_rows."""
    if h.dtype != torch.bfloat16 or h.dim() != 4 or h.shape[2:] != (T, cin):
        raise ValueError(f"h must be (N, core_rows+4, {T}, {cin}) bf16, got "
                         f"{tuple(h.shape)} {h.dtype}")
    if tw.cin != cin:
        raise ValueError(f"tail weights are for {tw.cin} channels, this "
                         f"tail takes {cin}")
    cr = h.shape[1] - 4
    if h.shape[0] != ny * nx or cr < 1:
        raise ValueError(f"h holds {h.shape[0]} tiles of {h.shape[1]} rows; "
                         f"expected {ny}x{nx} tiles of core_rows+4")
    if not 0 < height <= ny * cr or not 0 < width <= nx * CORE:
        raise ValueError(f"frame {height}x{width} is not covered by the "
                         f"{ny}x{nx} grid of {cr}x{CORE} cores")
    if not h.is_contiguous():
        raise ValueError("h must be contiguous")
    if tw.device != h.device:
        raise ValueError(f"tail weights on {tw.device}, h on {h.device}")
    return cr


@torch.no_grad()
def _twin_frame(h: torch.Tensor, tw: TailWeights, ny: int, nx: int,
                cr: int, height: int, width: int, bgr: bool) -> torch.Tensor:
    """The twins' common body: the tail per 16 tiles, crop-stitch, u8."""
    cores = []
    with _exact_f32():
        for s in range(0, h.shape[0], 16):
            fine = _tail_tiles_u8(h[s:s + 16], tw)
            cores.append(fine[:, 8:8 + 4 * cr, 8:8 + 4 * CORE])
    core = torch.cat(cores).reshape(ny, nx, 4 * cr, 4 * CORE, 3)
    frame = core.permute(0, 2, 1, 3, 4).reshape(ny * 4 * cr, nx * 4 * CORE, 3)
    frame = frame[:4 * height, :4 * width]
    return (frame.flip(-1) if bgr else frame).contiguous()


def fused_tail_u8_reference(h: torch.Tensor, tw: TailWeights, ny: int,
                            nx: int, height: int, width: int,
                            bgr: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: per tile conv -> d2s -> PReLU
    twice, then the output conv and tanh, then crop-stitch and u8.
    h: (ny*nx, cr+4, 124, 32) bf16 body output.  Returns the
    (4*height, 4*width, 3) uint8 frame.  Runs 16 tiles at a time to bound
    memory.  up1 sums in the kernel's order (_up1_sum); the
    other convs run at full f32 precision (cuDNN and TF32 off), and the
    w8a8 ones sum integers in f32, which is exact since |sum| <=
    127*127*288 < 2**24.  So w8a8 matches the kernel bit for bit but for
    tanh; bf16 differs where up2's and the output conv's sums round apart."""
    cr = _check(h, tw, CIN, ny, nx, height, width)
    launch_counts["fused_tail_u8_reference"] += 1
    return _twin_frame(h, tw, ny, nx, cr, height, width, bgr)


# ---------------------------------------------------------------------------
# the kernel

def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _launch(entry: str, h: torch.Tensor, tw: TailWeights, nx: int, cr: int,
            height: int, width: int, bgr: bool) -> torch.Tensor:
    """One launch of the tail kernel `entry` (a C function of the kernels'
    library; both tails share its signature) on h's device; raises unless
    that is a CUDA device."""
    require_cuda(h.device)
    if h.data_ptr() % 16:
        raise ValueError("h must be 16-byte aligned")
    from denoise_gan_tpu_torch.ops._build import load_library

    fn = getattr(load_library(), entry)
    out = torch.empty((4 * height, 4 * width, 3), dtype=torch.uint8,
                      device=h.device)
    with torch.cuda.device(h.device):     # the launch uses the current device
        err = fn(_ptr(h), _ptr(out), _ptr(tw.w1), _ptr(tw.b1), _ptr(tw.a1),
                 _ptr(tw.w2), _ptr(tw.b2), _ptr(tw.a2), _ptr(tw.w3),
                 _ptr(tw.b3), _ptr(tw.s2), _ptr(tw.s3),
                 ctypes.c_float(tw.inv_su1), ctypes.c_float(tw.inv_sr),
                 int(tw.q8), h.shape[0], nx, cr, height, width, int(bgr),
                 torch.cuda.current_stream(h.device).cuda_stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return out


def fused_tail_u8(h: torch.Tensor, tw: TailWeights, ny: int, nx: int,
                  height: int, width: int, bgr: bool = False) -> torch.Tensor:
    """The fused tail as one CUDA kernel launch (csrc/tail.cu); same
    contract as :func:`fused_tail_u8_reference`, which runs instead when h
    lies on the CPU.  Any other device launches the kernel or raises."""
    cr = _check(h, tw, CIN, ny, nx, height, width)
    if h.device.type == "cpu":
        return fused_tail_u8_reference(h, tw, ny, nx, height, width, bgr)
    out = _launch("dgt_tail_u8", h, tw, nx, cr, height, width, bgr)
    launch_counts["fused_tail_u8"] += 1
    return out
