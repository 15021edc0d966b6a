"""SRGAN (SRResNet) generator in PyTorch (denoise_gan_tpu/models/srgan.py:
23-93).

Train mode (``.train()``) normalises by the batch (models/layers.py::
BatchNorm).  The public modules take and return NHWC tensors, like the
Flax modules; inside they run NCHW views.  Flax names the body's layers
flat, in call order, and so does the port: the stem is ``Conv_0``,
``BatchNorm_0``, ``PReLU_0``; residual block k uses ``Conv_{2k+1}``,
``BatchNorm_{2k+1}``, ``Conv_{2k+2}``, ``BatchNorm_{2k+2}``; the post-conv
is ``Conv_{2n+1}``, ``BatchNorm_{2n+1}`` for n blocks.  The body's convs
have no bias.  Kernels start N(0, 0.02) and BatchNorm scales N(1, 0.02), as
in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from denoise_gan_tpu_torch.models.layers import (
    BatchNorm, Conv, PixelShuffleUp, PReLU, at_least_f32, conv3x3,
    gamma_normal02, normal02,
)


class SRGANBody(nn.Module):
    """Stem + residual blocks (conv-BN-ReLU-conv-BN + add) + post-conv with
    global skip, at input resolution (srgan.py:23-57).
    NHWC (N, H, W, 3) -> (N, H, W, filters)."""

    def __init__(self, num_res_blocks: int = 16, filters: int = 64,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_res_blocks = num_res_blocks
        self.filters = filters
        self.dtype = dtype
        for idx in range(2 * num_res_blocks + 2):
            setattr(self, f"Conv_{idx}", conv3x3(
                3 if idx == 0 else filters, filters, dtype, generator,
                use_bias=False, kernel_init=normal02))
            setattr(self, f"BatchNorm_{idx}", BatchNorm(
                filters, gamma_init=gamma_normal02, generator=generator))
            if idx == 0:
                self.PReLU_0 = PReLU(filters)

    def _conv_bn(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"BatchNorm_{idx}")(
            getattr(self, f"Conv_{idx}")(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        n = self.PReLU_0(self._conv_bn(0, x))
        temp = n
        for k in range(self.num_res_blocks):
            r = torch.relu(self._conv_bn(2 * k + 1, n))
            n = n + self._conv_bn(2 * k + 2, r)
        n = self._conv_bn(2 * self.num_res_blocks + 1, n)
        return (n + temp).permute(0, 2, 3, 1)


class SRGANTail(nn.Module):
    """scale // 2 pixel-shuffle 2x stages (conv to 256 each) + 1x1 conv +
    f32 tanh (srgan.py:60-77).  NHWC (N, H, W, cin) -> f32 in [-1, 1]."""

    def __init__(self, scale: int = 4, cin: int = 64,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stages = scale // 2
        for i in range(self.stages):
            setattr(self, f"up{i + 1}", PixelShuffleUp(
                cin if i == 0 else 64, 256, dtype, generator,
                kernel_init=normal02))
        self.out_conv = Conv(64 if self.stages else cin, 3, 1,
                             kernel_init=normal02, dtype=dtype,
                             generator=generator)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        x = h.permute(0, 3, 1, 2)
        for i in range(self.stages):
            x = getattr(self, f"up{i + 1}")(x)
        out = self.out_conv(x)
        return torch.tanh(at_least_f32(out)).permute(0, 2, 3, 1)


class SRGANGenerator(nn.Module):
    """16-block SRResNet; `scale` sets the number of 2x pixel-shuffle stages
    to scale // 2, as the reference (srgan.py:80-93).
    NHWC (N, H, W, 3) in [-1, 1] -> f32 in [-1, 1]."""

    def __init__(self, scale: int = 4, num_res_blocks: int = 16,
                 filters: int = 64, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.body = SRGANBody(num_res_blocks, filters, dtype, generator)
        self.tail = SRGANTail(scale, filters, dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail(self.body(x))
