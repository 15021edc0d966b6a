"""Denoising conv autoencoder in PyTorch (denoise_gan_tpu/models/
autoencoder.py:25-80).

A 5-level U-Net: 3x3 ReLU convs 32, 32 | 44 | 56 | 76 | 100, each level
ended by a SAME 2x2 max pool; then per level a nearest 2x "unpool" + ReLU,
a concat with the skip (the last one the raw input), and two 3x3 ReLU convs
(152 | 112 | 84 | 64 | 64, 32); a 3x3 conv to 3 channels and an f32 tanh.
Input resolution in and out (scale 1).  Flax names the convs flat, in call
order: ``Conv_0`` ... ``Conv_16``, and so does the port.  The ReLU convs
start he_normal, the tanh conv lecun_normal.  No BatchNorm.  The tanh is
single-threaded on the CPU (ops/tail.py::_tanh: multi-threaded, PyTorch's
CPU tanh is not the same from process to process).  H and W must
be multiples of 32 for the skips' shapes to meet, as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from denoise_gan_tpu_torch.models.layers import (
    at_least_f32, conv3x3, he_normal, lecun_normal, max_pool_same,
    upsample_nearest,
)
from denoise_gan_tpu_torch.ops.tail import _tanh

ENCODER = (32, 32, 44, 56, 76, 100)        # a pool after all but Conv_0
DECODER = ((152, 152), (112, 112), (84, 84), (64, 64), (64, 32))


class AutoencoderGenerator(nn.Module):
    """NHWC (N, H, W, 3) in [-1, 1] -> (N, H, W, 3) f32 in [-1, 1]."""

    def __init__(self, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        skips = [3] + list(ENCODER[1:-1])  # the input, pool1 ... pool4
        cin, idx = 3, 0
        for filters in ENCODER:
            self._conv(idx, cin, filters, he_normal, generator)
            cin, idx = filters, idx + 1
        for (f1, f2), skip in zip(DECODER, reversed(skips)):
            self._conv(idx, cin + skip, f1, he_normal, generator)
            self._conv(idx + 1, f1, f2, he_normal, generator)
            cin, idx = f2, idx + 2
        self._conv(idx, cin, 3, lecun_normal, generator)
        self.n_convs = idx + 1

    def _conv(self, idx, cin, cout, init, generator):
        setattr(self, f"Conv_{idx}", conv3x3(cin, cout, self.dtype,
                                             generator, kernel_init=init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        img = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)

        def conv_relu(h, idx):
            return torch.relu(getattr(self, f"Conv_{idx}")(h))

        h = conv_relu(img, 0)
        skips = [img]
        for idx in range(1, len(ENCODER)):
            h = max_pool_same(conv_relu(h, idx))
            skips.append(h)
        skips.pop()                             # the bottleneck is no skip
        idx = len(ENCODER)
        for skip in reversed(skips):
            # UpSampling2D(nearest) + ReLU, concat with the encoder skip
            h = torch.cat([torch.relu(upsample_nearest(h)), skip], dim=1)
            h = conv_relu(conv_relu(h, idx), idx + 1)
            idx += 2
        out = getattr(self, f"Conv_{idx}")(h)
        return _tanh(at_least_f32(out)).permute(0, 2, 3, 1)
