"""pix2pix U-Net generator in PyTorch (denoise_gan_tpu/models/pix2pix.py:
21-78).

Eight ``Downsample`` blocks (4x4 stride-2 SAME conv without bias, BN but in
the first, LeakyReLU 0.3) to a 1x1x512 bottleneck; seven ``Upsample``
blocks (4x4 stride-2 SAME transpose conv without bias, BN, dropout 0.5 in
the first three, ReLU), each followed by a concat with the mirrored
Downsample output; a last 4x4 stride-2 transpose conv with bias to 3
channels and an f32 tanh (single-threaded on the CPU, ops/tail.py::
_tanh).  Kernels start N(0, 0.02).  H and W must be
multiples of 256, as in the reference.

In eval mode BatchNorm applies its running statistics and dropout is the
identity; in train mode (``.train()``) BatchNorm normalises by the batch
and the three dropout layers drop half their values, from a
torch.Generator or from masks the caller passes (``forward``'s
``dropout``).  Names mirror the Flax scopes: ``Downsample_i/Conv_0``,
``Downsample_i/BatchNorm_0``, ``Upsample_i/ConvTranspose_0``,
``Upsample_i/BatchNorm_0`` and the top-level ``ConvTranspose_0``.
"""

from __future__ import annotations

import torch
from torch import nn

from denoise_gan_tpu_torch.models.layers import (
    BatchNorm, Conv, ConvTranspose, Dropout, at_least_f32, leaky_relu,
    normal02,
)
from denoise_gan_tpu_torch.ops.tail import _tanh

# (filters, BatchNorm) and (filters, dropout), as pix2pix.py:56-58
DOWN = [(64, False), (128, True), (256, True)] + [(512, True)] * 5
UP = [(512, True)] * 3 + [(512, False), (256, False), (128, False),
                          (64, False)]


class Downsample(nn.Module):
    def __init__(self, cin: int, filters: int, apply_batchnorm: bool = True,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 4, stride=2, use_bias=False,
                           kernel_init=normal02, dtype=dtype,
                           generator=generator)
        self.BatchNorm_0 = BatchNorm(filters) if apply_batchnorm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        return leaky_relu(x, 0.3)          # Keras LeakyReLU's default alpha


class Upsample(nn.Module):
    """Transpose conv, BN, dropout 0.5 where ``apply_dropout``, ReLU.
    ``keep``: the dropout's mask (NCHW, x's shape after the BN) or its
    torch.Generator (Dropout)."""

    def __init__(self, cin: int, filters: int, apply_dropout: bool = False,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(cin, filters, use_bias=False,
                                             dtype=dtype, generator=generator)
        self.BatchNorm_0 = BatchNorm(filters)
        self.dropout = Dropout(0.5) if apply_dropout else None

    def forward(self, x: torch.Tensor, keep=None) -> torch.Tensor:
        x = self.BatchNorm_0(self.ConvTranspose_0(x))
        if self.dropout is not None:
            x = self.dropout(x, keep)
        return torch.relu(x)


class Pix2PixGenerator(nn.Module):
    """NHWC (N, H, W, 3) in [-1, 1] -> (N, H, W, output_channels) f32 in
    [-1, 1]."""

    def __init__(self, output_channels: int = 3,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for i, (filters, bn) in enumerate(DOWN):
            setattr(self, f"Downsample_{i}", Downsample(
                cin, filters, bn, dtype, generator))
            cin = filters
        skips = [f for f, _ in DOWN[-2::-1]]
        for i, ((filters, drop), skip) in enumerate(zip(UP, skips)):
            setattr(self, f"Upsample_{i}", Upsample(cin, filters, drop,
                                                    dtype, generator))
            cin = filters + skip
        self.ConvTranspose_0 = ConvTranspose(cin, output_channels,
                                             dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor, dropout=None) -> torch.Tensor:
        """`dropout` (train mode only): a torch.Generator on x's device to
        draw the three masks from (None: torch's global one), a
        parallel/mesh.py::GlobalDraw (this rank's rows of them), or the masks
        themselves, NHWC booleans in call order, as flax.linen.Dropout
        draws them."""
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        skips = []
        for i in range(len(DOWN)):
            x = getattr(self, f"Downsample_{i}")(x)
            skips.append(x)
        masks = iter(dropout) if isinstance(dropout, (list, tuple)) else None
        for i, skip in enumerate(reversed(skips[:-1])):
            keep = dropout
            if UP[i][1] and masks is not None:
                keep = next(masks).permute(0, 3, 1, 2)
            x = torch.cat([getattr(self, f"Upsample_{i}")(x, keep), skip],
                          dim=1)
        x = self.ConvTranspose_0(x)
        return _tanh(at_least_f32(x)).permute(0, 2, 3, 1)
