"""PyTorch counterparts of the Flax building blocks the FSRGAN generator uses
(denoise_gan_tpu/models/layers.py:43-134).

Layers take NCHW tensors, PyTorch's convolution layout; the generator keeps
them in channels_last memory, so the storage is NHWC as on the JAX side.
Parameters are f32 and named after the Flax leaves (``weight`` for
``kernel``), so io/params.py maps a Flax tree one to one.  ``dtype`` is the
compute dtype: parameters are cast to it at each call, as Flax's
``dtype``/``param_dtype`` split does.  None computes in the input's dtype.
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F

from denoise_gan_tpu_torch.ops.image import depth_to_space_nchw


def _channel(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per-channel vector -> (1, C, 1, 1) in `dtype`."""
    return v.to(dtype).view(1, -1, 1, 1)


class PReLU(nn.Module):
    """Keras PReLU(shared_axes=[1, 2]): one slope per channel, zero-init
    (layers.py:43-54)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, _channel(self.alpha, x.dtype) * x)


class BatchNorm(nn.Module):
    """Keras-convention BatchNormalization, eval mode (layers.py:61-103):
    the running statistics fold to ``mul``/``add`` in f32, then apply in the
    compute dtype.  Train mode is not ported yet and raises."""

    def __init__(self, channels: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm is not ported yet; call .eval()")
        mul = self.scale * torch.rsqrt(self.var + self.epsilon)
        add = self.bias - self.mean * mul
        return x * _channel(mul, x.dtype) + _channel(add, x.dtype)


class Conv(nn.Module):
    """Stride-1 'SAME' convolution with Keras defaults: glorot-uniform
    kernel, zero bias (layers.py:106-117).  ``groups=channels`` is the
    depthwise form."""

    def __init__(self, cin: int, cout: int, kernel_size: int,
                 groups: int = 1, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("SAME padding here needs an odd kernel size")
        self.dtype = dtype
        self.groups = groups
        w = torch.empty(cout, cin // groups, kernel_size, kernel_size)
        receptive = kernel_size * kernel_size
        limit = math.sqrt(6.0 / ((cin // groups) * receptive
                                 + cout * receptive))
        w.uniform_(-limit, limit, generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The bias is added after the conv, as Flax does: in bf16 the conv
        # output is rounded before the add.  Fusing the bias into the conv
        # rounds once and changes ~60% of bf16 body outputs by an ulp.
        dt = self.dtype or x.dtype
        k = self.weight.shape[-1]
        y = F.conv2d(x.to(dt), self.weight.to(dt), padding=k // 2,
                     groups=self.groups)
        return y + _channel(self.bias, dt)


def conv3x3(cin: int, cout: int, dtype: torch.dtype | None = None,
            generator: torch.Generator | None = None) -> Conv:
    return Conv(cin, cout, 3, dtype=dtype, generator=generator)


class PixelShuffleUp(nn.Module):
    """conv(filters) -> depth_to_space(2) -> PReLU (layers.py:120-134)."""

    def __init__(self, cin: int, filters: int,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.Conv_0 = conv3x3(cin, filters, dtype, generator)
        self.PReLU_0 = PReLU(filters // 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.PReLU_0(depth_to_space_nchw(self.Conv_0(x), 2))
