"""PyTorch counterparts of the Flax building blocks the four generators use
(denoise_gan_tpu/models/layers.py:25-147, and flax.linen's ConvTranspose).

Layers take NCHW tensors, PyTorch's convolution layout; the generator keeps
them in channels_last memory, so the storage is NHWC as on the JAX side.
Parameters are f32 and named after the Flax leaves (``weight`` for
``kernel``), so io/params.py maps a Flax tree one to one.  ``dtype`` is the
compute dtype: parameters are cast to it at each call, as Flax's
``dtype``/``param_dtype`` split does.  None computes in the input's dtype.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch
from torch import nn
import torch.nn.functional as F

from denoise_gan_tpu_torch.ops.image import depth_to_space_nchw
from denoise_gan_tpu_torch.parallel import spatial
from denoise_gan_tpu_torch.parallel.mesh import (
    GlobalDraw, all_sum_grad, world_size,
)

# An initialiser fills a parameter in place from a CPU torch.Generator.
Init = Callable[[torch.Tensor, "torch.Generator | None"], None]


def glorot_uniform(w: torch.Tensor, generator=None) -> None:
    """Keras' default conv kernel init, for an OIHW kernel."""
    o, i, kh, kw = w.shape
    limit = math.sqrt(6.0 / ((i + o) * kh * kw))
    w.uniform_(-limit, limit, generator=generator)


def _fan_in_truncated_normal(w: torch.Tensor, scale: float,
                             generator=None) -> None:
    """flax's variance_scaling(scale, "fan_in", "truncated_normal") for an
    OIHW kernel: N(0, s) cut at +-2 s, s = sqrt(scale / fan_in) / .8796
    (the standard deviation of a unit normal cut at +-2)."""
    o, i, kh, kw = w.shape
    std = math.sqrt(scale / (i * kh * kw)) / .87962566103423978
    torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                generator=generator)


def he_normal(w: torch.Tensor, generator=None) -> None:
    """flax's he_normal (the autoencoder's ReLU convs)."""
    _fan_in_truncated_normal(w, 2.0, generator)


def lecun_normal(w: torch.Tensor, generator=None) -> None:
    """flax's lecun_normal (the autoencoder's tanh conv)."""
    _fan_in_truncated_normal(w, 1.0, generator)


def normal02(w: torch.Tensor, generator=None) -> None:
    """N(0, 0.02), the SRGAN kernels' init (layers.py:33-35)."""
    w.normal_(0.0, 0.02, generator=generator)


def gamma_normal02(w: torch.Tensor, generator=None) -> None:
    """N(1, 0.02), the SRGAN BatchNorm scales' init (layers.py:38-40)."""
    w.normal_(1.0, 0.02, generator=generator)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or float64 as it stands (a precision reference): where
    the JAX package casts a net's output or a loss's inputs to f32."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _channel(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per-channel vector -> (1, C, 1, 1) in `dtype`."""
    return v.to(dtype).view(1, -1, 1, 1)


def same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of lax's 'SAME' for size n, window k:
    total = max((ceil(n / s) - 1) * s + k - n, 0), before = total // 2.
    Odd totals (a 3x3 or 2x2 window at stride 2 on even sizes, a 4x4 one
    on odd sizes) pad one more after than before."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def leaky_relu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    """where(x >= 0, x, alpha * x) with alpha rounded to x's dtype, as
    JAX's weak float scalar is (layers.py:57-58): in bf16 the slope is
    bf16(alpha), and the product of two bf16 values rounds once."""
    a = torch.tensor(alpha, dtype=x.dtype).item()
    return torch.where(x >= 0, x, a * x)


def max_pool_same(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """Keras MaxPool2D(k, k, 'same') on NCHW (layers.py:137-141): lax's
    SAME pads with -inf, one more after than before."""
    (pt, pb), (pl, pr) = (same_pads(n, k, k) for n in x.shape[-2:])
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb), value=float("-inf"))
    return F.max_pool2d(x, k, k)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Keras UpSampling2D(nearest) on NCHW (layers.py:144-147)."""
    return x.repeat_interleave(factor, -2).repeat_interleave(factor, -1)


class PReLU(nn.Module):
    """Keras PReLU(shared_axes=[1, 2]): one slope per channel, zero-init
    (layers.py:43-54)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, _channel(self.alpha, x.dtype) * x)


class BatchNorm(nn.Module):
    """Keras-convention BatchNormalization (layers.py:61-103).

    Eval mode: the running statistics fold to ``mul``/``add`` in f32, then
    apply in the compute dtype.  Train mode, written out as Flax's is: the
    batch mean and the biased variance ``E[x^2] - mean^2`` over N, H, W in
    f32, ``(x - mean) * rsqrt(var + eps) * scale + bias`` in f32, cast back
    to the input's dtype; and, unless ``update_stats`` is False (see
    ``batch_stats_frozen``), the running statistics move by Keras momentum
    ``m``: ``running = m * running + (1 - m) * batch``, the variance biased
    (torch's own BatchNorm keeps ``1 - m`` and the unbiased variance).
    Under a process group of more than one rank the batch statistics are
    the global batch's (``_global_moments``), as under the JAX mesh.
    A float64 input computes in float64 (a precision reference)."""

    def __init__(self, channels: int, momentum: float = 0.99,
                 epsilon: float = 1e-3, gamma_init: Init | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.update_stats = True
        self.scale = nn.Parameter(torch.ones(channels))
        if gamma_init is not None:
            gamma_init(self.scale.data, generator)
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mul = self.scale * torch.rsqrt(self.var + self.epsilon)
            add = self.bias - self.mean * mul
            return x * _channel(mul, x.dtype) + _channel(add, x.dtype)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = (0, 2, 3)
        if world_size() > 1:
            mean, var = _global_moments(xf, axes)
        else:
            mean = xf.mean(dim=axes)
            var = xf.square().mean(dim=axes) - mean.square()
        if self.update_stats:
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        ft = xf.dtype
        y = ((xf - _channel(mean, ft))
             * _channel(torch.rsqrt(var + self.epsilon), ft)
             * _channel(self.scale, ft) + _channel(self.bias, ft))
        return y.to(x.dtype)


def _global_moments(xf: torch.Tensor, axes: tuple[int, ...]
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The batch mean and E[x^2] - mean^2 over the global batch of a
    process group (parallel/mesh.py), as GSPMD computes them under the
    JAX mesh: each rank's per-channel sum, sum of squares and count, in
    xf's dtype, summed over the ranks by a differentiable all-reduce, so
    that the gradients flow through the global statistics."""
    c = xf.shape[1]
    count = torch.full((1,), xf.numel() // c, dtype=xf.dtype,
                       device=xf.device)
    tot = all_sum_grad(torch.cat([xf.sum(dim=axes),
                                  xf.square().sum(dim=axes), count]))
    mean = tot[:c] / tot[-1]
    return mean, tot[c:2 * c] / tot[-1] - mean.square()


@contextlib.contextmanager
def batch_stats_frozen(model: nn.Module):
    """Inside the block, `model`'s BatchNorm layers normalise by batch
    statistics in train mode but leave their running statistics as they
    are: Flax's ``apply(..., mutable=["batch_stats"])`` whose update is
    thrown away (train/step.py: D(fake) in the generator's loss, pix2pix's
    identity pass)."""
    layers = [m for m in model.modules() if isinstance(m, BatchNorm)]
    old = [m.update_stats for m in layers]
    for m in layers:
        m.update_stats = False
    try:
        yield
    finally:
        for m, u in zip(layers, old):
            m.update_stats = u


class Dropout(nn.Module):
    """flax.linen.Dropout(rate) (pix2pix.py:48-49): in train mode
    ``where(keep, x / (1 - rate), 0)``, each value kept with probability
    1 - rate (at 0.5 a kept value doubles, exactly); the identity in eval
    mode.  ``keep`` is a boolean mask of x's shape that the caller passes,
    or a draw of ``torch.rand < 1 - rate`` from the caller's
    torch.Generator (on x's device; None: torch's global one), or from a
    parallel/mesh.py::GlobalDraw (this rank's rows of a global draw)."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                keep: torch.Tensor | torch.Generator | None = None
                ) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        if isinstance(keep, GlobalDraw):
            keep = keep.rand(x.shape, x.device) < keep_prob
        elif not isinstance(keep, torch.Tensor):
            keep = torch.rand(x.shape, generator=keep,
                              device=x.device) < keep_prob
        if keep.shape != x.shape:
            raise ValueError(f"dropout mask {tuple(keep.shape)} for input "
                             f"{tuple(x.shape)}")
        return torch.where(keep.to(x.device), x / keep_prob,
                           torch.zeros((), dtype=x.dtype, device=x.device))


class Conv(nn.Module):
    """'SAME' convolution with Keras defaults: glorot-uniform kernel, zero
    bias (layers.py:106-117).  Any square kernel and stride; the padding is
    lax's SAME rule (``same_pads``), which pads one more after than before
    where the total is odd, or none at all with ``padding="VALID"``.
    Under parallel/spatial.py::rows_split H's SAME padding is the
    neighbouring ranks' rows (zeros only at the frame's top and bottom).
    ``groups=channels`` is the depthwise form; ``use_bias=False`` has no
    ``bias`` parameter at all, as Flax's."""

    def __init__(self, cin: int, cout: int, kernel_size: int,
                 groups: int = 1, use_bias: bool = True,
                 kernel_init: Init = glorot_uniform,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None,
                 stride: int = 1, padding: str = "SAME"):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding}")
        self.dtype = dtype
        self.groups = groups
        self.stride = stride
        self.same = padding == "SAME"
        w = torch.empty(cout, cin // groups, kernel_size, kernel_size)
        kernel_init(w, generator)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The bias is added after the conv, as Flax does: in bf16 the conv
        # output is rounded before the add.  Fusing the bias into the conv
        # rounds once and changes ~60% of bf16 body outputs by an ulp.
        dt = self.dtype or x.dtype
        k, s = self.weight.shape[-1], self.stride
        (pt, pb), (pl, pr) = ((same_pads(n, k, s) if self.same else (0, 0))
                              for n in x.shape[-2:])
        x = x.to(dt)
        if (pt or pb) and spatial.active() is not None:
            # the frame's rows split over the ranks (parallel/spatial.py):
            # H's padding is the neighbouring ranks' rows
            x, pt, pb = spatial.halo(x, pt, pb, s), 0, 0
        if (pt, pl) != (pb, pr):
            x, pt, pl = F.pad(x, (pl, pr, pt, pb)), 0, 0
        y = F.conv2d(x, self.weight.to(dt), stride=s, padding=(pt, pl),
                     groups=self.groups)
        return y if self.bias is None else y + _channel(self.bias, dt)


class ConvTranspose(nn.Module):
    """flax.linen.ConvTranspose(features, (k, k), strides=(s, s),
    padding='SAME') with transpose_kernel=False, on NCHW.  lax pads the
    s-dilated input by (a, b), a = ceil((k + s - 2) / 2) (k - 1 if s >
    k - 1), b = k + s - 2 - a, and correlates it with the Flax kernel as
    it stands; torch's conv_transpose2d pads k - 1 - p before and after
    (plus output_padding after) and correlates with the kernel flipped.
    So ``weight`` is torch's (in, out, k, k) layout of the Flax
    (k, k, in, out) kernel flipped in both spatial axes (io/params.py does
    the flip), p = k - 1 - a and output_padding = b - a.  4x4 at stride 2
    (pix2pix) gives a = b = 2: p = 1 on both sides, for even and odd
    sizes; pairs torch cannot pad so raise ValueError."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 4,
                 stride: int = 2, use_bias: bool = True,
                 kernel_init: Init = normal02,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        k, s = kernel_size, stride
        a = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
        b = k + s - 2 - a
        if not (0 <= k - 1 - a and 0 <= b - a < s):
            raise ValueError(f"SAME ConvTranspose with kernel {k}, stride "
                             f"{s} has no conv_transpose2d padding")
        self.dtype = dtype
        self.stride = s
        self.padding = k - 1 - a
        self.output_padding = b - a
        w = torch.empty(cin, cout, k, k)
        kernel_init(w, generator)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                               stride=self.stride, padding=self.padding,
                               output_padding=self.output_padding)
        return y if self.bias is None else y + _channel(self.bias, dt)


def conv3x3(cin: int, cout: int, dtype: torch.dtype | None = None,
            generator: torch.Generator | None = None, use_bias: bool = True,
            kernel_init: Init = glorot_uniform) -> Conv:
    return Conv(cin, cout, 3, use_bias=use_bias, kernel_init=kernel_init,
                dtype=dtype, generator=generator)


class PixelShuffleUp(nn.Module):
    """conv(filters) -> depth_to_space(2) -> PReLU (layers.py:120-134)."""

    def __init__(self, cin: int, filters: int,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None,
                 kernel_init: Init = glorot_uniform):
        super().__init__()
        self.Conv_0 = conv3x3(cin, filters, dtype, generator,
                              kernel_init=kernel_init)
        self.PReLU_0 = PReLU(filters // 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.PReLU_0(depth_to_space_nchw(self.Conv_0(x), 2))
