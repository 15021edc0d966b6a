"""Fused inverted residual (K3) and the FSRGAN body built on it.

Counterpart of tools/exp_mbconv_kernel.py (``_mbconv_kernel``,
``fold_conv_bn``, ``build_pallas_fsrgan_body``).  Three pieces:

* weight preparation: ``fold_conv_bn`` and ``prepare_mbconv`` fold a
  port :class:`~denoise_gan_tpu_torch.models.fsrgan.InvertedResidual` and
  its BatchNorms into :class:`MBConvWeights`;
* ``fused_mbconv``, the wrapper of the CUDA kernel in ``csrc/mbconv.cu``;
* ``fused_mbconv_reference``, the kernel's plain PyTorch version.  The
  wrapper runs it for a tensor on the CPU; on a CUDA tensor it launches the
  kernel or raises.

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

Every sum runs in the kernel's order (expand: input channel 0..C-1; the
depthwise: tap row, then tap column; project: expanded channel 0..E-1), so
kernel and plain version agree bit for bit: the bf16 x bf16 products are
exact in f32, and the depthwise's f32 x bf16 products are rounded once in
both.
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
E_CHUNK = 32     # the kernel walks the expanded channels in chunks of this
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
    of 32."""
    _check(x, w)
    if x.device.type == "cpu":
        return fused_mbconv_reference(x, w)
    require_cuda(x.device)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bf16 x and weights, got "
                         f"{x.dtype} and {w.dtype}")
    if x.shape[-1] != C or w.e_dim % E_CHUNK or \
            (not w.has_expand and w.e_dim != C):
        raise ValueError(f"the kernel takes {C} channels and E a multiple of "
                         f"{E_CHUNK}, got {x.shape[-1]} and {w.e_dim}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous NHWC and 16-byte aligned")
    if x.shape[0] > 65535:
        raise ValueError("at most 65535 images per launch")
    from denoise_gan_tpu_torch.ops._build import load_library

    out = torch.empty_like(x)
    n, hh, ww, _ = x.shape
    with torch.cuda.device(x.device):     # the launch uses the current device
        err = load_library().dgt_mbconv(
            _ptr(x), _ptr(out), _ptr(w.we), _ptr(w.be), _ptr(w.wd),
            _ptr(w.bd), _ptr(w.wp), _ptr(w.bp), n, hh, ww, w.e_dim,
            int(w.residual), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"dgt_mbconv launch failed: CUDA error {err}")
    launch_counts["fused_mbconv"] += 1
    return out


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
