"""Fused inverted residual (K3) and the FSRGAN body built on it.

Counterpart of tools/exp_mbconv_kernel.py (``_mbconv_kernel``,
``fold_conv_bn``, ``build_pallas_fsrgan_body``).  Three pieces:

* weight preparation: ``fold_conv_bn`` and ``prepare_mbconv`` fold a
  port :class:`~denoise_gan_tpu_torch.models.fsrgan.InvertedResidual` and
  its BatchNorms into :class:`MBConvWeights`;
* ``fused_mbconv``, the wrapper of the CUDA kernel in ``csrc/mbconv.cu``;
* ``fused_mbconv_reference``, the kernel's plain PyTorch version.  The
  wrapper runs it for a tensor on the CPU; on a CUDA tensor it launches the
  kernel or raises;
* the kernel's margins in plain PyTorch (``margin_parts``, ``d_margin``,
  ``y_margin``, ``certain``), its parameters as compiled
  (``kernel_params``), and inputs where its sum errors add up
  (``one_sign_x``, ``one_sign_block``).

One block, NHWC, BN folded:

    e = relu(x @ we + be)            bf16 x bf16 summed in f32; e stays f32
    d = bf16(relu(dw3x3(e) + bd))    f32 e x wd, one rounding per product
                                     and per sum (no fused multiply-add)
    y = (d @ wp + bp) + x            bf16 x bf16 summed in f32, cast to x's
                                     dtype

Block 0 has no expand: e = x.  The depthwise sees e as zero outside the
image (SAME padding on the expanded tensor), as the model's
``InvertedResidual`` does.  The TPU kernel pads x instead, so its e is
``relu(be)`` on the ring outside the image, and its border pixels differ
from the model wherever ``be > 0``; the port does not copy that.

The plain version sums the expand over input channel 0..C-1 and the
project over expanded channel 0..E-1, one product at a time, and the
depthwise by tap row, then tap column.  The kernel sums the expand and the
project on the tensor cores, in an order of their own, and keeps such a
result only where its bf16 rounding (d, after ReLU; y) is certain within a
margin that covers both orders (``d_margin``, ``y_margin``, ``certain``;
the argument is in csrc/mbconv.cu's header); it recomputes the other
values in the plain order.  So kernel and plain version agree bit for bit:
the bf16 x bf16 products are exact in f32, and the depthwise's f32 x bf16
products are rounded once in both.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from denoise_gan_tpu_torch.models.fsrgan import FSRGANBody, InvertedResidual
from denoise_gan_tpu_torch.models.layers import BatchNorm, Conv
from denoise_gan_tpu_torch.utils.device import require_cuda

C = 32           # FSRGAN residual stream channels
E_STEP = 32      # the kernel takes E a multiple of this
E_MAX = 192      # and at most this
E_CHUNK = 16     # the kernel walks the expanded channels in chunks of this
BLOCK = (16, 16)  # the kernel's unit: output rows, cols
THREADS = 512    # the kernel's threads a block
TILE_CHUNK = 16  # the plain version runs this many images at a time

# Plain integers: the kernel's launches and the plain version's calls.
launch_counts = {"fused_mbconv": 0, "fused_mbconv_reference": 0}


# ---------------------------------------------------------------------------
# weight preparation

def fold_conv_bn(kernel, bias, bn_params, bn_stats, eps: float = 1e-3):
    """conv -> BatchNorm(running stats) == conv with rescaled weights, in
    f32 numpy (tools/exp_mbconv_kernel.py:127-134).  kernel is HWIO, so the
    scale broadcasts over its last (output) axis."""
    kernel = np.asarray(kernel, np.float32)
    bias = np.asarray(bias, np.float32) if bias is not None \
        else np.zeros(kernel.shape[-1], np.float32)
    s = np.asarray(bn_params["scale"]) / np.sqrt(np.asarray(bn_stats["var"])
                                                 + eps)
    return kernel * s, (bias - np.asarray(bn_stats["mean"])) * s \
        + np.asarray(bn_params["bias"])


def _fold(conv: Conv, bn: BatchNorm) -> tuple[np.ndarray, np.ndarray]:
    """fold_conv_bn of a port Conv (OIHW) and BatchNorm; HWIO kernel."""
    def f32(t):
        return None if t is None else t.detach().cpu().numpy()

    return fold_conv_bn(f32(conv.weight).transpose(2, 3, 1, 0), f32(conv.bias),
                        {"scale": f32(bn.scale), "bias": f32(bn.bias)},
                        {"mean": f32(bn.mean), "var": f32(bn.var)},
                        eps=bn.epsilon)


@dataclass(frozen=True)
class MBConvWeights:
    """One BN-folded inverted residual at C channels with E expanded ones,
    in one dtype on one device: we (C, E) and be (E,) (None without an
    expand, where E = C), wd (3, 3, E), bd (E,), wp (E, C), bp (C,)."""

    we: torch.Tensor | None
    be: torch.Tensor | None
    wd: torch.Tensor
    bd: torch.Tensor
    wp: torch.Tensor
    bp: torch.Tensor
    residual: bool = True

    @property
    def has_expand(self) -> bool:
        return self.we is not None

    @property
    def e_dim(self) -> int:
        return self.wd.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.wd.device

    @property
    def dtype(self) -> torch.dtype:
        return self.wd.dtype


def prepare_mbconv(block: InvertedResidual, dtype: torch.dtype = torch.bfloat16
                   ) -> MBConvWeights:
    """MBConvWeights of a port InvertedResidual on its device, folded in f32
    and then cast to `dtype` (as the JAX side's ``as_dt``)."""
    dev = block.depthwise.weight.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    bn = int(block.has_expand)
    we = be = None
    if block.has_expand:
        we, be = _fold(block.expand, block.BatchNorm_0)
        we, be = t(we[0, 0]), t(be)                    # (1,1,C,E) -> (C,E)
    wd, bd = _fold(block.depthwise, getattr(block, f"BatchNorm_{bn}"))
    wp, bp = _fold(block.project, getattr(block, f"BatchNorm_{bn + 1}"))
    return MBConvWeights(we=we, be=be, wd=t(wd[:, :, 0, :]), bd=t(bd),
                         wp=t(wp[0, 0]), bp=t(bp), residual=block.residual)


# ---------------------------------------------------------------------------
# the plain version

def _check(x: torch.Tensor, w: MBConvWeights) -> None:
    if x.dim() != 4 or x.shape[-1] != w.wp.shape[-1]:
        raise ValueError(f"x must be (N, H, W, {w.wp.shape[-1]}), got "
                         f"{tuple(x.shape)}")
    if w.device != x.device:
        raise ValueError(f"block weights on {w.device}, x on {x.device}")


def _block(x: torch.Tensor, w: MBConvWeights) -> torch.Tensor:
    """One block on (n, H, W, C) x, in the kernel's order (module
    docstring)."""
    n, hh, ww, c = x.shape
    xf = x.float()
    if w.has_expand:
        we = w.we.float()
        e = xf.new_zeros((n, hh, ww, w.e_dim))
        for ci in range(c):
            e.addcmul_(xf[..., ci:ci + 1], we[ci])
        e = torch.relu(e + w.be.float())
    else:
        e = xf
    ep = F.pad(e, (0, 0, 1, 1, 1, 1))              # zero outside the image
    wd = w.wd.float()
    acc = torch.zeros_like(e)
    for dr in range(3):
        for dc in range(3):
            acc = acc + ep[:, dr:dr + hh, dc:dc + ww] * wd[dr, dc]
    d = torch.relu(acc + w.bd.float()).to(x.dtype).float()
    wp = w.wp.float()
    p = xf.new_zeros((n, hh, ww, wp.shape[1]))
    for k in range(w.e_dim):
        p.addcmul_(d[..., k:k + 1], wp[k])
    p = p + w.bp.float()
    if w.residual:
        p = p + xf
    return p.to(x.dtype)


@torch.no_grad()
def fused_mbconv_reference(x: torch.Tensor, w: MBConvWeights) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one BN-folded inverted residual
    on NHWC x (N, H, W, C), SAME on the expanded tensor, returned in x's
    dtype.  Runs TILE_CHUNK images at a time to bound memory."""
    _check(x, w)
    launch_counts["fused_mbconv_reference"] += 1
    return torch.cat([_block(x[s:s + TILE_CHUNK], w)
                      for s in range(0, x.shape[0], TILE_CHUNK)])


# ---------------------------------------------------------------------------
# the kernel

def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def fused_mbconv(x: torch.Tensor, w: MBConvWeights) -> torch.Tensor:
    """One inverted residual as one CUDA kernel launch (csrc/mbconv.cu);
    same contract as :func:`fused_mbconv_reference`, which runs instead when
    x lies on the CPU.  Any other device launches the kernel or raises: it
    takes x (N, H, W, 32) bf16 contiguous and bf16 weights with E a multiple
    of 32, at most E_MAX."""
    _check(x, w)
    if x.device.type == "cpu":
        return fused_mbconv_reference(x, w)
    out = _launch("dgt_mbconv", x, w)
    launch_counts["fused_mbconv"] += 1
    return out


def _launch(entry: str, x: torch.Tensor, w: MBConvWeights, *extra
            ) -> torch.Tensor:
    """The kernel through the C function `entry`, on the card; raises on
    arguments the kernel does not take."""
    require_cuda(x.device)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bf16 x and weights, got "
                         f"{x.dtype} and {w.dtype}")
    if x.shape[-1] != C or w.e_dim % E_STEP or w.e_dim > E_MAX or \
            (not w.has_expand and w.e_dim != C):
        raise ValueError(f"the kernel takes {C} channels and E a multiple of "
                         f"{E_STEP} up to {E_MAX}, got {x.shape[-1]} and "
                         f"{w.e_dim}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous NHWC and 16-byte aligned")
    if x.shape[0] > 65535:
        raise ValueError("at most 65535 images per launch")
    from denoise_gan_tpu_torch.ops._build import load_library

    out = torch.empty_like(x)
    n, hh, ww, _ = x.shape
    with torch.cuda.device(x.device):     # the launch uses the current device
        err = getattr(load_library(), entry)(
            _ptr(x), _ptr(out), _ptr(w.we), _ptr(w.be), _ptr(w.wd),
            _ptr(w.bd), _ptr(w.wp), _ptr(w.bp), n, hh, ww, w.e_dim,
            int(w.residual), *extra,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return out


# the check form's phases (csrc/mbconv.cu::Phase): the tensor-core warps'
# unit start (x patch, |x|), barrier waits, expand, project, y test and
# y repair; the depthwise warps' waits, depthwise, d test (and store), d
# repair, y repair
PHASES = ("tc_start", "tc_wait", "tc_expand", "tc_project", "tc_y_test",
          "tc_y_repair", "dw_wait", "dw_depthwise", "dw_d_test",
          "dw_d_repair", "dw_y_repair")


def fused_mbconv_counted(x: torch.Tensor, w: MBConvWeights
                         ) -> tuple[torch.Tensor, int, int, dict[str, int]]:
    """A check of the kernel, which no path of the model runs: its check
    form on x (dgt_mbconv_counted; not counted as a launch of
    :func:`fused_mbconv`), with the number of d and of y values whose
    rounding its margins left uncertain, so that it recomputed them in the
    plain order, and the clock64 cycles that the first thread of each role
    spent in each of PHASES, summed over the blocks.  Returns (y, d values
    repaired, y values repaired, {phase: cycles}); needs the card."""
    _check(x, w)
    counts = torch.zeros(2 + len(PHASES), dtype=torch.int64, device=x.device)
    y = _launch("dgt_mbconv_counted", x, w, _ptr(counts))
    got = [int(v) for v in counts.cpu()]
    return y, got[0], got[1], dict(zip(PHASES, got[2:]))


def kernel_params() -> tuple[tuple[float, ...], tuple[int, ...]]:
    """The kernel's margin parts and geometry as compiled
    (dgt_mbconv_params): ((the plain order's part and the tensor core's at
    the expand, the tensor core's and the plain order's at the project,
    ROUND_E, ROUND_DW, ROUND_Y), (unit rows, unit cols, E_CHUNK,
    THREADS)); ``margin_parts`` and the constants mirror them.  Needs the
    card's toolkit."""
    from denoise_gan_tpu_torch.ops._build import load_library

    err = (ctypes.c_float * 7)()
    geom = (ctypes.c_int * 4)()
    code = load_library().dgt_mbconv_params(err, geom)
    if code:
        raise RuntimeError(f"dgt_mbconv_params failed: CUDA error {code}")
    return tuple(float(v) for v in err), tuple(geom)


def occupancy(expand: bool) -> tuple[int, int]:
    """(dynamic shared memory in bytes, resident blocks an SM) of the
    kernel's frame form with or without the expand, as its launch sets
    them; needs the card."""
    from denoise_gan_tpu_torch.ops.tail import occupancy as query

    return query("dgt_mbconv_occupancy", int(expand))


# ---------------------------------------------------------------------------
# the kernel's margins (csrc/mbconv.cu, header note), in plain PyTorch

U = 2.0 ** -24
# mma.sync's sum error allowances relative to |x| |w| at the expand (K = 32)
# and the project (K = E); chip_smoke.py's phase 3b holds each at 10x what
# it measures for chained bf16 mma.sync at those K
ERR_MMA_EXPAND = float(np.float32(1.5e-6))
ERR_MMA_PROJECT = float(np.float32(5e-6))
# the plain order's part at the project, per chunk boundary: 16u
PLAIN_Y = E_CHUNK * U
# the roundings between a sum and its test, in units of the magnitudes
ROUND_E = 2 * U      # + be, at the expand
ROUND_DW = 20 * U    # the depthwise's products and sums, and + bd
ROUND_Y = 4 * U
SLACK = 1 + 2.0 ** -10


def sum_err(k: int) -> float:
    """gamma_{k-1}, rounded up as the kernel rounds it: the plain order's
    sum error bound relative to |x| |w| for k bf16 products."""
    from denoise_gan_tpu_torch.ops.tail import up1_err

    return up1_err(k)[0]


def margin_parts() -> tuple[float, ...]:
    """The margin parts the kernel reports (kernel_params)."""
    return (sum_err(C), ERR_MMA_EXPAND, ERR_MMA_PROJECT, PLAIN_Y, ROUND_E,
            ROUND_DW, ROUND_Y)


@torch.no_grad()
def d_margin(x: torch.Tensor, w: MBConvWeights, e: torch.Tensor
             ) -> torch.Tensor:
    """The d test's margin for x (N, H, W, C), an expanding block and the
    expanded tensor e (N, H, W, E) that the depthwise reads (>= 0): for
    every output and channel k, the sum over its 3 x 3 taps t of |wd_t|
    (alpha_k |x_t| + ROUND_DW e_t), plus beta_k, all times SLACK; |x_t| the
    norm of x at the tap's pixel (L2 over the channels, 0 outside the
    image), alpha_k = W (ERR_MMA_EXPAND + gamma_31 + ROUND_E), beta_k =
    ROUND_E Wd |be| + 2u |bd|, W = |we[:, k]|, Wd = sum |wd[:, k]|; f32
    (N, H, W, E)."""
    hh, ww = e.shape[1:3]
    xn = x.double().square().sum(-1, keepdim=True).sqrt()
    alpha = w.we.double().norm(dim=0) * (ERR_MMA_EXPAND + sum_err(C)
                                         + ROUND_E)
    zp = F.pad(alpha * xn + ROUND_DW * e.double(), (0, 0, 1, 1, 1, 1))
    wa = w.wd.double().abs()
    mag = sum(zp[:, dr:dr + hh, dc:dc + ww] * wa[dr, dc]
              for dr in range(3) for dc in range(3))
    beta = ROUND_E * wa.sum((0, 1)) * w.be.double().abs() \
        + 2 * U * w.bd.double().abs()
    return (SLACK * (mag + beta)).float()


@torch.no_grad()
def y_margin(d: torch.Tensor, x: torch.Tensor, w: MBConvWeights
             ) -> torch.Tensor:
    """The y test's margin from the block's d (N, H, W, E) and x (N, H, W,
    C): SLACK (P V (ERR_MMA_PROJECT + PLAIN_Y + ROUND_Y) + PLAIN_Y sum_j M_j
    + ROUND_Y |bp| + 2u |x|), P = |d| at the output (L2 over E), V =
    |wp[:, c]|, M_j the largest |p| after the first j chunks of E_CHUNK
    over the 8 channels that share c's lane in the kernel (c mod 8 // 2;
    here summed exactly); f32 (N, H, W, C)."""
    df, wpd = d.double(), w.wp.double()
    p = df.square().sum(-1, keepdim=True).sqrt()
    v = wpd.norm(dim=0)
    pm = torch.zeros(df.shape[:-1] + (1, 4, 1), dtype=torch.float64)
    for k in range(E_CHUNK, w.e_dim, E_CHUNK):
        pk = (df[..., :k] @ wpd[:k]).abs().unflatten(-1, (4, 4, 2))
        pm += pk.amax((-3, -1), keepdim=True)
    pm = pm.expand(df.shape[:-1] + (4, 4, 2)).flatten(-3)
    xr = x.double().abs() if w.residual else torch.zeros_like(x.double())
    m = p * v * (ERR_MMA_PROJECT + PLAIN_Y + ROUND_Y) + PLAIN_Y * pm \
        + ROUND_Y * w.bp.double().abs() + 2 * U * xr
    return (SLACK * m).float()


def certain(v: torch.Tensor, m: torch.Tensor, relu: bool) -> torch.Tensor:
    """The kernel's certainty test on f32 v: True where the bf16 rounding
    of v (of relu(v) when `relu`) holds for every value within m of v; 4u
    |v| more covers the roundings of v -+ m, as in the kernel."""
    v, m = v.float(), m.float()
    d = m + v.abs() * 2.0 ** -22
    lo, hi = v - d, v + d
    if relu:
        lo, hi = lo.clamp_min(0), hi.clamp_min(0)
    return lo.to(torch.bfloat16).view(torch.int16) == \
        hi.to(torch.bfloat16).view(torch.int16)


def one_sign_x(shape: tuple[int, ...], generator: torch.Generator,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """bf16 block inputs >= 0: |N(0, 1)|."""
    return torch.randn(shape, generator=generator).abs().to(device,
                                                            torch.bfloat16)


@torch.no_grad()
def one_sign_block(w: MBConvWeights, x: torch.Tensor) -> MBConvWeights:
    """The block with every expand, depthwise and project weight its
    magnitude, so that on x >= 0 (``one_sign_x``) every product of the two
    sums is >= 0: where their rounding errors add up instead of cancelling.
    be, bd and bp become minus the means over x of the sums they are added
    to, so the large sums cancel against them and the roundings after them
    see their errors whole.  Returns new weights of w's dtype and device."""
    dt = w.dtype
    we = None if w.we is None else w.we.abs()
    wd, wp = w.wd.abs(), w.wp.abs()
    xf = x.float()
    be = None
    if we is not None:
        s = xf @ we.float()
        be = -s.mean((0, 1, 2))
        e = torch.relu(s + be.to(dt).float())
    else:
        e = xf
    acc = F.conv2d(e.permute(0, 3, 1, 2), wd.float().permute(2, 0, 1)[:, None],
                   padding=1, groups=w.e_dim).permute(0, 2, 3, 1)
    bd = -acc.mean((0, 1, 2))
    d = torch.relu(acc + bd.to(dt).float()).to(dt).float()
    bp = -(d @ wp.float()).mean((0, 1, 2))
    return MBConvWeights(we=we, be=None if be is None else be.to(dt), wd=wd,
                         bd=bd.to(dt), wp=wp, bp=bp.to(dt),
                         residual=w.residual)


# ---------------------------------------------------------------------------
# the FSRGAN body

class MBConvFSRGANBody(nn.Module):
    """FSRGANBody's inference forward with its inverted residuals as fused
    blocks: stem 3x3 conv (BN folded) + bias, PReLU; one ``block_fn`` call
    per block; post 3x3 conv (BN folded) + bias + the global skip.  The
    stem and post convs are ``F.conv2d``.  NHWC (N, H, W, 3) -> (N, H, W,
    32) in the body's dtype.  Built by :func:`build_mbconv_fsrgan_body`."""

    def __init__(self, stem_k, stem_b, alpha, blocks, post_k, post_b,
                 block_fn: Callable):
        super().__init__()
        self.stem_k, self.stem_b, self.alpha = stem_k, stem_b, alpha
        self.blocks = blocks
        self.post_k, self.post_b = post_k, post_b
        self.block_fn = block_fn

    @property
    def dtype(self) -> torch.dtype:
        return self.stem_k.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        h = F.conv2d(x, self.stem_k, padding=1) + self.stem_b.view(1, -1, 1, 1)
        c1 = torch.where(h >= 0, h, self.alpha.view(1, -1, 1, 1) * h)
        r = c1.permute(0, 2, 3, 1).contiguous()
        for w in self.blocks:
            r = self.block_fn(r, w)
        h = F.conv2d(r.permute(0, 3, 1, 2), self.post_k, padding=1) \
            + self.post_b.view(1, -1, 1, 1)
        return (h + c1).permute(0, 2, 3, 1)


def build_mbconv_fsrgan_body(body: FSRGANBody,
                             block_fn: Callable = fused_mbconv
                             ) -> MBConvFSRGANBody:
    """The counterpart of build_pallas_fsrgan_body
    (tools/exp_mbconv_kernel.py:137-224) from a port FSRGANBody (eval mode,
    weights loaded, e.g. by ``from_jax_params``), on its device, in its
    compute dtype (f32 when it has none).  Weights are folded in f32, then
    cast.  `block_fn` is ``fused_mbconv`` or its plain version."""
    dtype = body.dtype or torch.float32
    dev = body.Conv_0.weight.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    stem_k, stem_b = _fold(body.Conv_0, body.BatchNorm_0)
    post_k, post_b = _fold(body.Conv_1, body.BatchNorm_1)
    blocks = [prepare_mbconv(getattr(body, f"InvertedResidual_{i}"), dtype)
              for i in range(body.n_residual_blocks)]
    return MBConvFSRGANBody(
        t(stem_k.transpose(3, 2, 0, 1)), t(stem_b),
        body.PReLU_0.alpha.detach().to(dev, dtype), blocks,
        t(post_k.transpose(3, 2, 0, 1)), t(post_b), block_fn).eval()
