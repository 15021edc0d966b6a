"""Fused FSRGAN tail: up1 -> up2 -> out_conv -> tanh -> crop-stitch -> u8
(or a bf16 canvas).

Counterpart of denoise_gan_tpu/ops/pallas/tail.py.  Three pieces, and
what the kernels' tests and reports share:

* weight preparation (``prep_weights``, ``prep_weights_q8``,
  ``calibrate_tail_scales``, ``calibrate_h_scales``, ``prepare_tail``) ->
  :class:`TailWeights`, and ``quantize_h``, the int8 input of qh8 mode;
* the wrappers of the CUDA kernel in ``csrc/tail.cu``: ``fused_tail_u8``
  (u8 epilogue) and ``fused_tail_canvas`` (canvas epilogue);
* their plain PyTorch twins ``fused_tail_u8_reference`` and
  ``fused_tail_canvas_reference``: the same function with quantisation and
  rounding at the same points.  A wrapper runs its twin for a tensor on the
  CPU; on a CUDA tensor it launches the kernel or raises;
* the kernel's index maps in plain Python (``up2_rows``, ``out_rows``,
  ``chunk_rows``, ``out_w3_fragments``), which the CPU tests hold against
  the twin's convolutions; ``up1_err``, the sum error bound of
  csrc/tail_common.cuh; ``one_sign_up1_`` and ``one_sign_h``, inputs on
  which every up1 product has one sign; and ``sass_counts``,
  ``ptxas_report`` and ``occupancy``, which report on a built tail kernel
  (K1's and K2's).

The weight preparation, the twin's arithmetic and the launch are written
for any body width (CIN) and output-conv size; ops/tail_srgan.py reuses
them for the SRGAN tail (CIN=64, 1x1 output conv).

Geometry (as the JAX engine): tiles are (core_rows + 4, T=124) coarse
pixels with CIN channels; the core of a tile is coarse rows [2, 2+cr) and
cols [2, 122), i.e. fine [8, 8+4cr) x [8, 488), and the cores of an
(ny, nx) grid tile the frame.  Every core pixel depends only on its own tile,
so no SAME padding reaches the output.

Modes (chosen by the weights, ``TailWeights.mode``):

* bf16: bf16 operands, f32 sums; up1 and up2 outputs are rounded to bf16
  before the next conv.
* w8a8: up1 as in bf16; up2 and the output conv are int8 x int8 -> int32
  with per-output-channel weight scales and static activation scales (u1
  and R quantised from f32, round half to even, clip to +-127), dequantised
  as ``int32 * (s_w * s_act) + bias``.  As in the JAX kernel
  (tail.py:439-453), a 3x3 output conv's taps that reach the neighbouring
  4-column group (output fine column 4j+f reading column 4j-1 or 4j+4)
  read R quantised from its bf16 copy instead.
* qh8: w8a8, with h itself int8 (``quantize_h``: one step size per body
  channel, calibrated as ``calibrate_h_scales``) and up1 int8 x int8 ->
  int32, the h step sizes folded into W1 before its per-output-channel
  quantisation (tail.py:179-213, :373-377).

Epilogues: tanh is rounded to bf16; u8 = trunc(clip((v+1)*127.5 + 0.5, 0,
255)), RGB or BGR; the canvas is that bf16 value itself, RGB (the JAX
package's ``build_fused_tail``, depth_to_space'd and cropped).
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import re
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
MODES = ("bf16", "w8a8", "qh8")     # numbered as csrc/tail_common.cuh::Mode


def mode_counts(*names: str) -> dict[str, int]:
    """Launch counts keyed "<name>:<mode>", all zero."""
    return {f"{n}:{m}": 0 for n in names for m in MODES}


# Plain integers: the kernel's launches and the twins' calls, per mode.
launch_counts = mode_counts("fused_tail_u8", "fused_tail_u8_reference",
                            "fused_tail_canvas",
                            "fused_tail_canvas_reference")


@dataclass(frozen=True)
class TailWeights:
    """Tail weights in the kernels' layouts, on one device, for a body of C
    channels (C = 32: FSRGAN, 3x3 output conv; C = 64: SRGAN, 1x1).  Conv
    rows are k = (dy*kw + dx)*C + cin (HWIO flattened); conv output channel
    q = (a*2 + b)*C + t goes to depth_to_space phase (a, b), channel t.
    K3 = kh*kw*C is the output conv's depth.  An int8 matrix of K rows is
    packed (K/4, N, 4): 4 consecutive k of one column per int32 word.

    bf16 mode: w1, w2 (9C, 4C) and w3 (K3, 3) bf16.
    w8a8 mode: w1 as bf16; w2 int8 (9C/4, 4C, 4), w3 (3, K3) int8, and the
    dequant scales s2 (4C,), s3 (3,) f32 (weight scale x activation scale);
    inv_su1/inv_sr quantise u1 and R.
    qh8 mode: as w8a8, with w1 int8 (9C/4, 4C, 4) of W1 times the h step
    sizes, its dequant scales s1 (4C,), and inv_sh (C,), the reciprocal h
    step sizes that ``quantize_h`` multiplies by."""

    w1: torch.Tensor
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
    s1: torch.Tensor | None = None
    inv_sh: torch.Tensor | None = None

    @property
    def q8(self) -> bool:
        return self.s2 is not None

    @property
    def qh8(self) -> bool:
        return self.s1 is not None

    @property
    def mode(self) -> str:
        return "qh8" if self.qh8 else "w8a8" if self.q8 else "bf16"

    @property
    def h_dtype(self) -> torch.dtype:
        """The dtype of the body output the tail takes."""
        return torch.int8 if self.qh8 else torch.bfloat16

    @property
    def device(self) -> torch.device:
        return self.w1.device

    @property
    def cin(self) -> int:
        return self.a1.shape[0]

    def conv_weights(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(w1, w2, w3) as OIHW f32 (bf16 values, or int8 integers)."""
        c = self.cin

        def unpack(w):
            return w.permute(0, 2, 1).reshape(-1, 4 * c)

        w1 = unpack(self.w1) if self.qh8 else self.w1
        w2 = unpack(self.w2) if self.q8 else self.w2
        w3 = self.w3.t() if self.q8 else self.w3
        k3 = math.isqrt(w3.shape[0] // c)
        return tuple(w.float().reshape(k, k, c, -1).permute(3, 2, 0, 1)
                     for w, k in ((w1, 3), (w2, 3), (w3, k3)))


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


def _pack4(w: np.ndarray) -> np.ndarray:
    """An int8 HWIO conv weight as (K/4, N, 4): 4 consecutive k per word."""
    return w.reshape(-1, 4, w.shape[-1]).transpose(0, 2, 1)


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


@torch.no_grad()
def calibrate_h_scales(h_sample: torch.Tensor,
                       margin: float = 1.0) -> np.ndarray:
    """Per-channel int8 step sizes of the body output for the qh8 tail:
    sH[c] = max|h[..., c]| over the sample tiles (NHWC) times margin / 127,
    floored at 1e-9, in f32 as tail.py:167-176 computes them."""
    m = h_sample.float().abs().amax(dim=tuple(range(h_sample.dim() - 1)))
    m = m.cpu().numpy()
    return np.maximum(m * np.float32(margin) / np.float32(127.0),
                      np.float32(1e-9)).astype(np.float32)


def prepare_tail(tail: nn.Module, q8_calib: torch.Tensor | None = None,
                 device: torch.device | str | None = None,
                 qh8: bool = False) -> TailWeights:
    """TailWeights for `tail` (FSRGANTail or SRGANTail) on `device`
    (default: the tail's).  With q8_calib (sample body-output tiles, NHWC)
    the tail runs w8a8 with activation scales calibrated on it at
    Q8_MARGIN, or qh8 when `qh8` (the h step sizes calibrated on it too);
    else bf16.  qh8 without q8_calib raises ValueError."""
    if qh8 and q8_calib is None:
        raise ValueError("qh8 calibrates its h step sizes on q8_calib, and "
                         "none was given")
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
    if qh8:
        sh = calibrate_h_scales(q8_calib, margin=Q8_MARGIN)
        w1q, s1 = _quantize_per_output(w["W1"] * sh[:, None])
        common.update(w1=t(_pack4(w1q), torch.int8), s1=t(s1),
                      inv_sh=t(np.float32(1.0) / sh))
    return TailWeights(
        w2=t(_pack4(w["W2q"]), torch.int8),
        w3=t(w["W3q"].reshape(-1, 3).T, torch.int8),
        s2=t(w["s2w"] * np.float32(su1)), s3=t(w["s3w"] * np.float32(sr)),
        inv_su1=float(np.float32(1.0 / su1)),
        inv_sr=float(np.float32(1.0 / sr)), **common)


def quantize_h(h: torch.Tensor, tw: TailWeights) -> torch.Tensor:
    """The qh8 tail's input: clip(round(f32(h) * inv_sh), +-127) as int8,
    per body channel, rounding half to even (make_h3_q8, tail.py:196-213,
    in the port's NHWC layout).  h: (N, TR, T, C) body output."""
    if not tw.qh8:
        raise ValueError(f"quantize_h needs qh8 tail weights, got {tw.mode}")
    q = torch.round(h.float() * tw.inv_sh)
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


# ---------------------------------------------------------------------------
# the twin

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _quant(x: torch.Tensor, inv: float) -> torch.Tensor:
    return torch.clamp(torch.round(x * inv), -127.0, 127.0)


def _to_u8(v: torch.Tensor) -> torch.Tensor:
    u = (_bf16(v) + 1.0) * 127.5 + 0.5
    return torch.clamp(u, 0.0, 255.0).to(torch.uint8)


def _to_canvas(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16)


def _tanh(y: torch.Tensor) -> torch.Tensor:
    """torch.tanh, single-threaded on the CPU.  Multi-threaded, PyTorch's
    CPU tanh gives one thread's share of the elements a less accurate
    result in some processes and not in others (up to 1.5e-5 apart; seen
    with MKL on AVX-512), so the twin's bytes would change from run to run.
    On the card it is the kernel's tanhf."""
    if y.device.type != "cpu":
        return torch.tanh(y)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return torch.tanh(y)
    finally:
        torch.set_num_threads(threads)


def _up1_sum(x: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """up1's 3x3 SAME conv, summed one product at a time, tap-major then
    input channel, in f32: K1's bf16 mode sums in this order, and in w8a8
    both kernels sum again in it every value whose int8 step their
    tensor-core sum leaves uncertain.  The bf16 x bf16 products are exact
    in f32, so the sums are bit for bit the kernels', and w8a8 quantises
    the same u1.  (A conv library sums in its own order; that moves a few
    u1 values across an int8 rounding boundary, and each such flip moves
    nearby output bytes by up to 2 levels.)"""
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


def _tail_tiles(h: torch.Tensor, tw: TailWeights) -> torch.Tensor:
    """(n, TR, T, C) tiles (bf16, or int8 for qh8) -> (n, 4TR, 4T, 3) f32
    tanh, per-tile SAME.  Columns are tile-local, so column 4j starts a
    4-column group."""
    w1, w2, w3 = tw.conv_weights()
    x = h.float().permute(0, 3, 1, 2)
    if tw.qh8:       # integer sums, exact in f32 (|sum| <= 127*127*9C)
        c1 = _conv(x, w1) * _bias(tw.s1) + _bias(tw.b1)
    else:
        c1 = _up1_sum(x, w1) + _bias(tw.b1)
    u1 = _prelu(depth_to_space_nchw(c1, 2), tw.a1)
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
    return _tanh(y).permute(0, 2, 3, 1)


def _check(h: torch.Tensor, tw: TailWeights, cin: int, ny: int, nx: int,
           height: int, width: int, bgr: bool, canvas: bool) -> int:
    """Validate a tail's inputs for a body of `cin` channels; returns
    core_rows."""
    if h.dtype != tw.h_dtype or h.dim() != 4 or h.shape[2:] != (T, cin):
        raise ValueError(f"h must be (N, core_rows+4, {T}, {cin}) "
                         f"{tw.h_dtype} for {tw.mode} tail weights, got "
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
    if canvas and bgr:
        raise ValueError("the canvas epilogue writes RGB; BGR needs the u8 "
                         "epilogue")
    return cr


@torch.no_grad()
def _twin_frame(h: torch.Tensor, tw: TailWeights, ny: int, nx: int,
                cr: int, height: int, width: int, bgr: bool,
                canvas: bool) -> torch.Tensor:
    """The twins' common body: the tail per 16 tiles, crop-stitch, and the
    u8 or canvas epilogue."""
    epilogue = _to_canvas if canvas else _to_u8
    cores = []
    with _exact_f32():
        for s in range(0, h.shape[0], 16):
            fine = epilogue(_tail_tiles(h[s:s + 16], tw))
            cores.append(fine[:, 8:8 + 4 * cr, 8:8 + 4 * CORE])
    core = torch.cat(cores).reshape(ny, nx, 4 * cr, 4 * CORE, 3)
    frame = core.permute(0, 2, 1, 3, 4).reshape(ny * 4 * cr, nx * 4 * CORE, 3)
    frame = frame[:4 * height, :4 * width]
    return (frame.flip(-1) if bgr else frame).contiguous()


def run_twin(name: str, counts: dict[str, int], cin: int, h: torch.Tensor,
             tw: TailWeights, ny: int, nx: int, height: int, width: int,
             bgr: bool, canvas: bool) -> torch.Tensor:
    """A twin's call: check, count under `name`, compute."""
    cr = _check(h, tw, cin, ny, nx, height, width, bgr, canvas)
    counts[f"{name}:{tw.mode}"] += 1
    return _twin_frame(h, tw, ny, nx, cr, height, width, bgr, canvas)


def fused_tail_u8_reference(h: torch.Tensor, tw: TailWeights, ny: int,
                            nx: int, height: int, width: int,
                            bgr: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: per tile conv -> d2s -> PReLU
    twice, then the output conv and tanh, then crop-stitch and u8.
    h: (ny*nx, cr+4, 124, 32) body output, bf16 (int8 for qh8 weights,
    from :func:`quantize_h`).  Returns the (4*height, 4*width, 3) uint8
    frame.  Runs 16 tiles at a time to bound memory.  up1 sums in the
    kernel's order (_up1_sum, which its w8a8 repair returns to; qh8:
    integers, exact in any order); the other
    convs run at full f32 precision (cuDNN and TF32 off), and the int8 ones
    sum integers in f32, which is exact since |sum| <= 127*127*288 < 2**24.
    So w8a8 and qh8 match the kernel bit for bit but for tanh; bf16 differs
    where up2's and the output conv's sums round apart."""
    return run_twin("fused_tail_u8_reference", launch_counts, CIN, h, tw,
                    ny, nx, height, width, bgr, canvas=False)


def fused_tail_canvas_reference(h: torch.Tensor, tw: TailWeights, ny: int,
                                nx: int, height: int, width: int,
                                bgr: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the canvas epilogue: as
    :func:`fused_tail_u8_reference`, returning the (4*height, 4*width, 3)
    bf16 frame of tanh, RGB; bgr=True raises ValueError."""
    return run_twin("fused_tail_canvas_reference", launch_counts, CIN, h, tw,
                    ny, nx, height, width, bgr, canvas=True)


# ---------------------------------------------------------------------------
# the kernel

def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _launch(entry: str, h: torch.Tensor, tw: TailWeights, nx: int, cr: int,
            height: int, width: int, bgr: bool,
            canvas: bool) -> torch.Tensor:
    """One launch of the tail kernel `entry` (a C function of the kernels'
    library; both tails share its signature) on h's device; raises unless
    that is a CUDA device."""
    require_cuda(h.device)
    if h.data_ptr() % 16:
        raise ValueError("h must be 16-byte aligned")
    from denoise_gan_tpu_torch.ops._build import load_library

    fn = getattr(load_library(), entry)
    out = torch.empty((4 * height, 4 * width, 3),
                      dtype=torch.bfloat16 if canvas else torch.uint8,
                      device=h.device)
    with torch.cuda.device(h.device):     # the launch uses the current device
        err = fn(_ptr(h), _ptr(out), _ptr(tw.w1), _ptr(tw.b1), _ptr(tw.a1),
                 _ptr(tw.w2), _ptr(tw.b2), _ptr(tw.a2), _ptr(tw.w3),
                 _ptr(tw.b3), _ptr(tw.s1), _ptr(tw.s2), _ptr(tw.s3),
                 ctypes.c_float(tw.inv_su1), ctypes.c_float(tw.inv_sr),
                 MODES.index(tw.mode), int(canvas), h.shape[0], nx, cr,
                 height, width, int(bgr),
                 torch.cuda.current_stream(h.device).cuda_stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return out


def run_kernel(name: str, counts: dict[str, int], entry: str, twin,
               cin: int, h: torch.Tensor, tw: TailWeights, ny: int, nx: int,
               height: int, width: int, bgr: bool,
               canvas: bool) -> torch.Tensor:
    """A wrapper's call: the twin for h on the CPU, else one launch of the
    C function `entry`, counted under `name`, or an exception."""
    cr = _check(h, tw, cin, ny, nx, height, width, bgr, canvas)
    if h.device.type == "cpu":
        return twin(h, tw, ny, nx, height, width, bgr)
    out = _launch(entry, h, tw, nx, cr, height, width, bgr, canvas)
    counts[f"{name}:{tw.mode}"] += 1
    return out


def fused_tail_u8(h: torch.Tensor, tw: TailWeights, ny: int, nx: int,
                  height: int, width: int, bgr: bool = False) -> torch.Tensor:
    """The fused tail as one CUDA kernel launch (csrc/tail.cu); same
    contract as :func:`fused_tail_u8_reference`, which runs instead when h
    lies on the CPU.  Any other device launches the kernel or raises."""
    return run_kernel("fused_tail_u8", launch_counts, "dgt_tail",
                      fused_tail_u8_reference, CIN, h, tw, ny, nx, height,
                      width, bgr, canvas=False)


def fused_tail_canvas(h: torch.Tensor, tw: TailWeights, ny: int, nx: int,
                      height: int, width: int,
                      bgr: bool = False) -> torch.Tensor:
    """The fused tail with the canvas epilogue as one CUDA kernel launch
    (csrc/tail.cu); same contract as :func:`fused_tail_canvas_reference`,
    which runs instead when h lies on the CPU."""
    return run_kernel("fused_tail_canvas", launch_counts, "dgt_tail",
                      fused_tail_canvas_reference, CIN, h, tw, ny, nx,
                      height, width, bgr, canvas=True)


# ---------------------------------------------------------------------------
# the kernel's index maps (csrc/tail.cu), in plain Python

# core rows x cols of a block (csrc/tail.cu BR, BC) and up2's 2x rows a
# chunk (CH); the kernel reports its own (kernel_params), and chip_smoke.py
# and the gpu tests hold the two equal
BLOCK = (15, 8)
CHUNK = 8


def up2_rows(br: int = BLOCK[0], bc: int = BLOCK[1]) -> np.ndarray:
    """up2's A rows in a block: for each position (Y, X) of its
    (2br+2) x (2bc+2) 2x grid, row-major, and tap (du, dv), the u1 row it
    reads as (u1 position i*(bc+2) + j, phase block a*2 + b): d1 (Y+du,
    X+dv) is U1 ((Y+du)/2, (X+dv)/2), phase ((Y+du)&1, (X+dv)&1).  U1
    position (i, j) is tile (r0+1+i, c0+1+j) of a block at core (r0, c0),
    and up2's output (Y, X) is the 2x tile position (2r0+3+Y, 2c0+3+X).
    Shape (positions, 9, 2)."""
    y, x = np.divmod(np.arange((2 * br + 2) * (2 * bc + 2)), 2 * bc + 2)
    du, dv = np.divmod(np.arange(9), 3)
    d, e = y[:, None] + du, x[:, None] + dv
    return np.stack([(d >> 1) * (bc + 2) + (e >> 1), (d & 1) * 2 + (e & 1)],
                    axis=-1)


def out_rows(br: int = BLOCK[0], bc: int = BLOCK[1]) -> np.ndarray:
    """The output conv's A rows in a block: for each output pixel (oy, ox)
    of its 4br x 4bc, row-major, and tap (dy, dx), (R row, R column, 1 where
    the int8 modes read R quantised from its bf16 copy, else 0).  R row rho,
    column kappa hold up2's output (Y, X) at phase (a, b) = (rho&1,
    kappa&1), fine tile pixel (4r0+6+rho, 4c0+6+kappa); output (oy, ox) is
    fine tile pixel (8+4r0+oy, 8+4c0+ox), tile-local column 4j + (ox & 3).
    Shape (pixels, 9, 3)."""
    oy, ox = np.divmod(np.arange(16 * br * bc), 4 * bc)
    dy, dx = np.divmod(np.arange(9), 3)
    f = ox[:, None] % 4
    edge = ((dx == 0) & (f == 0)) | ((dx == 2) & (f == 3))
    return np.stack([np.broadcast_to(oy[:, None] + 1 + dy, edge.shape),
                     ox[:, None] + 1 + dx, edge.astype(np.int64)], axis=-1)


def chunk_rows(br: int = BLOCK[0], ch: int = CHUNK
               ) -> list[tuple[range, range]]:
    """The kernel's chunks: (R rows that chunk k's up2 writes, output rows
    that its output conv then computes), the R rows in a ring of 2ch + 2."""
    outs, lo = [], 0
    for k in range((2 * br + 2) // ch):
        hi = min(2 * ch * (k + 1) - 4, 4 * br - 1)
        outs.append((range(2 * ch * k, 2 * ch * (k + 1)), range(lo, hi + 1)))
        lo = hi + 1
    return outs


def out_w3_fragments(tw: TailWeights) -> np.ndarray:
    """The output conv's B fragments as the kernel keeps them, N = 3
    padded to 8: for each k-step (int8 one a tap, bf16 two) and lane
    (g, t), two 32-bit words of column g (zero for g >= 3): int8 words
    8s + t and 8s + 4 + t of w3 (3, 72); bf16 the pairs (k, k + 1) and
    (k + 8, k + 9), k = 16s + 2t, of w3 (288, 3), the lower k in the low
    half.  Shape (steps, 32, 2) uint32."""
    g, t = np.divmod(np.arange(32), 4)
    if tw.q8:
        w = tw.w3.cpu().contiguous().view(torch.int32).numpy().view(np.uint32)
        s = np.arange(9)[:, None]
        cols = np.minimum(g, 2)
        frag = np.stack([w[cols, 8 * s + t], w[cols, 8 * s + 4 + t]], -1)
    else:
        w = tw.w3.cpu().contiguous().view(torch.int16).numpy().view(np.uint16)
        w = w.astype(np.uint32)
        k = 16 * np.arange(18)[:, None] + 2 * t
        cols = np.minimum(g, 2)
        frag = np.stack([w[k, cols] | w[k + 1, cols] << 16,
                         w[k + 8, cols] | w[k + 9, cols] << 16], -1)
    return np.where((g < 3)[None, :, None], frag, 0).astype(np.uint32)


# ---------------------------------------------------------------------------
# up1's sum error bound, and inputs that test it

# the tensor core's part of up1's sum error bound (tail_common.cuh; the
# kernels report theirs, kernel_params)
UP1_ERR_MMA = 2.0 ** -16


def up1_err(k: int) -> tuple[float, float]:
    """(the twin's part, the tensor core's part) of up1's sum error bound
    relative to |x| |w| for k <= 576 bf16 products, as
    csrc/tail_common.cuh::up1_err: gamma_{k-1} = (k-1) u / (1 - (k-1) u),
    u = 2**-24, rounded up, proven for the twin's order (recursive
    summation, one rounding a product); UP1_ERR_MMA, an allowance that
    chip_smoke.py's phase 3b holds at 10x what it measures."""
    n = (k - 1) * 2.0 ** -24
    return float(np.float32(n / (1 - n) * (1 + 2.0 ** -20))), UP1_ERR_MMA


# the mean of one_sign_h's values: 2 E|N(0, 1)|
ONE_SIGN_H_MEAN = 2.0 * math.sqrt(2.0 / math.pi)


@torch.no_grad()
def one_sign_up1_(tail: nn.Module) -> nn.Module:
    """Make every up1 weight of the tail (FSRGANTail, SRGANTail) its
    magnitude, in place, so that with ``one_sign_h`` every up1 product is
    >= 0: where rounding errors add up instead of cancelling.  The bias is
    set to minus the sum's mean on those inputs, so u1 has both signs and
    the frame is not flat, and the large sums cancel against it: u1's
    rounding sees their errors whole.  Returns the tail."""
    conv = tail.up1.Conv_0
    conv.weight.abs_()
    conv.bias.copy_(-ONE_SIGN_H_MEAN * conv.weight.sum(dim=(1, 2, 3)))
    return tail


def one_sign_h(shape: tuple[int, ...], generator: torch.Generator,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """bf16 body-output tiles >= 0 at the top of the body's range: |N(0,
    1)| times 2 (mean ONE_SIGN_H_MEAN)."""
    return (torch.randn(shape, generator=generator).abs() * 2.0).to(
        device, torch.bfloat16)


# ---------------------------------------------------------------------------
# the built kernels (K1 "tail_kernel", K2 "tail64_kernel"; K3's
# "mbconv_kernel" through the same reports)

def _instance(kernel: str, name: str) -> tuple | None:
    """The template arguments of an instantiation of the kernel named
    `kernel` in a mangled name, or None: a tail kernel's (mode, canvas),
    K3's (expand, check)."""
    m = re.search(rf"\d{kernel}I((?:L[ib]\d+E)+)E", name)
    if not m:
        return None
    args = re.findall(r"L([ib])(\d+)E", m[1])
    return tuple(MODES[int(v)] if t == "i" else v == "1" for t, v in args)


def sass_counts(kernel: str) -> dict[tuple, dict[str, int]]:
    """IMMA and HMMA instructions (the tensor-core products) in each
    instantiation of the kernel named `kernel` (a tail kernel's by (mode,
    canvas), K3's "mbconv_kernel" by (expand, check)), from the built
    library's SASS (``_build.sass_functions``); {} where the toolkit has
    no cuobjdump."""
    from denoise_gan_tpu_torch.ops import _build

    counts = {}
    for name, block in _build.sass_functions().items():
        key = _instance(kernel, name)
        if key:
            lines = block.splitlines()
            counts[key] = {op: sum(op in line for line in lines)
                           for op in ("IMMA", "HMMA")}
    return counts


def kernel_params(entry: str, mode: str
                  ) -> tuple[float, float, tuple[int, int, int]]:
    """A tail kernel's parameters in `mode` as compiled, from the C
    function `entry` (dgt_tail_params, dgt_tail64_params): (up1's margin
    relative to |x| |w|, 0 where the mode has no repair; the tensor core's
    allowance within it, 0 where the margin is not built from the bound;
    (block core rows, cols, up2's 2x rows a chunk or 0)).  Needs the
    card's toolkit."""
    from denoise_gan_tpu_torch.ops._build import load_library

    err = (ctypes.c_float * 2)()
    geom = (ctypes.c_int * 3)()
    code = getattr(load_library(), entry)(MODES.index(mode), err, geom)
    if code:
        raise RuntimeError(f"{entry} failed: CUDA error {code}")
    return float(err[0]), float(err[1]), tuple(geom)


def up1_certain(z: torch.Tensor, a: torch.Tensor, xerr: torch.Tensor,
                wn: torch.Tensor, inv: float, q8: bool) -> torch.Tensor:
    """The kernels' up1 certainty test (csrc/tail_common.cuh::up1_certain,
    by the C function dgt_up1_certain) on f32 tensors of one shape on a
    CUDA device: True where u1 = prelu(z, a) keeps its rounding (q8: the
    int8 step q(u1 * inv); else bf16) for every sum within xerr * wn of z.
    A check of the kernels, with no plain version: raises off a CUDA
    device."""
    require_cuda(z.device)
    ts = [t.to(torch.float32).contiguous() for t in (z, a, xerr, wn)]
    if any(t.shape != z.shape or t.device != z.device for t in ts):
        raise ValueError("z, a, xerr and wn must share a shape and device")
    from denoise_gan_tpu_torch.ops._build import load_library

    out = torch.empty(z.shape, dtype=torch.uint8, device=z.device)
    with torch.cuda.device(z.device):
        code = load_library().dgt_up1_certain(
            *(t.data_ptr() for t in ts), out.data_ptr(), ctypes.c_float(inv),
            z.numel(), int(q8),
            torch.cuda.current_stream(z.device).cuda_stream)
    if code:
        raise RuntimeError(f"dgt_up1_certain launch failed: CUDA error {code}")
    return out.bool()


def occupancy(entry: str, *args: str | bool | int) -> tuple[int, int]:
    """(dynamic shared memory in bytes, resident blocks an SM) of a built
    kernel's instantiation, as its launch sets them, from the C function
    `entry`: a tail kernel's (dgt_tail_occupancy, dgt_tail64_occupancy) by
    its mode and epilogue (canvas), K3's (dgt_mbconv_occupancy) by whether
    it expands; a mode by name.  Needs the card."""
    from denoise_gan_tpu_torch.ops._build import load_library

    smem, blocks = ctypes.c_int(), ctypes.c_int()
    ints = [MODES.index(a) if isinstance(a, str) else int(a) for a in args]
    err = getattr(load_library(), entry)(*ints, ctypes.byref(smem),
                                         ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    return smem.value, blocks.value


def ptxas_report(kernel: str) -> dict[tuple, dict[str, int]]:
    """Registers and spill bytes of each instantiation of the kernel named
    `kernel`, keyed as by ``sass_counts``, from the ptxas report of the
    build made in this process (``_build.build_log``); {} where this
    process built nothing."""
    from denoise_gan_tpu_torch.ops import _build

    report, key = {}, None
    for line in _build.build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            key = _instance(kernel, m[1])
            if key:
                report[key] = {}
        elif key and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            report[key].update(stack=nums[0], spill_stores=nums[1],
                               spill_loads=nums[2])
        elif key and "Used" in line and "registers" in line:
            report[key]["registers"] = int(
                re.search(r"Used (\d+) registers", line)[1])
            key = None
    return report
