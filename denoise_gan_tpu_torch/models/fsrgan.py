"""FastSRGAN generator in PyTorch (denoise_gan_tpu/models/fsrgan.py:22-129).

Train mode (``.train()``) normalises by the batch (models/layers.py::
BatchNorm).  The public modules take and return NHWC tensors, like the
Flax modules; inside they run NCHW views of channels_last storage, which
cuDNN convolves without a relayout.  Submodule names mirror the Flax scopes
(``Conv_0``, ``InvertedResidual_3``, ``up1`` ...).
"""

from __future__ import annotations

import torch
from torch import nn

from denoise_gan_tpu_torch.models.layers import (
    BatchNorm, Conv, PixelShuffleUp, PReLU, at_least_f32, conv3x3,
)

EXPANSION = 6     # inverted-residual expand factor (width multiplier 1)
BN_MOMENTUM = 0.999   # the inverted residuals' BatchNorm momentum


def _make_divisible(v, divisor, min_value=None):
    """MobileNetV2 channel rounding (fsrgan.py:22-29)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class InvertedResidual(nn.Module):
    """MobileNetV2 inverted residual, stride 1, BN eps 1e-3 and momentum
    0.999 (fsrgan.py:32-71).  Block 0 has no expand conv."""

    def __init__(self, in_channels: int, filters: int, block_id: int,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        out_channels = _make_divisible(filters, 8)
        self.residual = in_channels == out_channels
        self.has_expand = bool(block_id)
        mid = in_channels
        if self.has_expand:
            mid = EXPANSION * in_channels
            self.expand = Conv(in_channels, mid, 1, dtype=dtype,
                               generator=generator)
            self.BatchNorm_0 = BatchNorm(mid, BN_MOMENTUM)
        bn = int(self.has_expand)
        self.depthwise = Conv(mid, mid, 3, groups=mid, dtype=dtype,
                              generator=generator)
        setattr(self, f"BatchNorm_{bn}", BatchNorm(mid, BN_MOMENTUM))
        self.project = Conv(mid, out_channels, 1, dtype=dtype,
                            generator=generator)
        setattr(self, f"BatchNorm_{bn + 1}",
                BatchNorm(out_channels, BN_MOMENTUM))

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = inputs
        bn = int(self.has_expand)
        if self.has_expand:
            x = torch.relu(self.BatchNorm_0(self.expand(x)))
        x = torch.relu(getattr(self, f"BatchNorm_{bn}")(self.depthwise(x)))
        x = getattr(self, f"BatchNorm_{bn + 1}")(self.project(x))
        return inputs + x if self.residual else x


class FSRGANBody(nn.Module):
    """Stem + inverted residuals + post-conv with global skip, at input
    resolution (fsrgan.py:74-96).  NHWC (N, H, W, 3) -> (N, H, W, gf)."""

    def __init__(self, gf: int = 32, n_residual_blocks: int = 6,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.gf = gf
        self.n_residual_blocks = n_residual_blocks
        self.dtype = dtype
        self.Conv_0 = conv3x3(3, gf, dtype, generator)
        self.BatchNorm_0 = BatchNorm(gf)
        self.PReLU_0 = PReLU(gf)
        for idx in range(n_residual_blocks):
            setattr(self, f"InvertedResidual_{idx}",
                    InvertedResidual(gf, gf, idx, dtype=dtype,
                                     generator=generator))
        self.Conv_1 = conv3x3(gf, gf, dtype, generator)
        self.BatchNorm_1 = BatchNorm(gf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        c1 = self.PReLU_0(self.BatchNorm_0(self.Conv_0(x)))
        r = c1
        for idx in range(self.n_residual_blocks):
            r = getattr(self, f"InvertedResidual_{idx}")(r)
        c2 = self.BatchNorm_1(self.Conv_1(r))
        return (c2 + c1).permute(0, 2, 3, 1)


class FSRGANTail(nn.Module):
    """Two pixel-shuffle 2x stages + 3-channel conv + f32 tanh
    (fsrgan.py:99-113).  NHWC (N, H, W, gf) -> (N, 4H, 4W, 3) f32."""

    def __init__(self, gf: int = 32, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.up1 = PixelShuffleUp(gf, gf * 4, dtype, generator)
        self.up2 = PixelShuffleUp(gf, gf * 4, dtype, generator)
        self.out_conv = conv3x3(gf, 3, dtype, generator)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        u2 = self.up2(self.up1(h.permute(0, 3, 1, 2)))
        out = self.out_conv(u2)
        return torch.tanh(at_least_f32(out)).permute(0, 2, 3, 1)


class FSRGANGenerator(nn.Module):
    """gf=32, 6 inverted residuals, fixed 4x upsample (fsrgan.py:116-129).
    NHWC (N, H, W, 3) in [-1, 1] -> (N, 4H, 4W, 3) f32 in [-1, 1]."""

    def __init__(self, gf: int = 32, n_residual_blocks: int = 6,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.body = FSRGANBody(gf, n_residual_blocks, dtype, generator)
        self.tail = FSRGANTail(gf, dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail(self.body(x))
