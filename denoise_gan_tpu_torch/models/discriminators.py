"""The discriminators in PyTorch (denoise_gan_tpu/models/discriminators.py:
29-143).

* ``PatchDiscriminator``: 8 conv blocks (df, df, df, df, 2df, 2df, 2df,
  2df; strides 1, 2, 1, 2, ...; BN momentum 0.8 but in the first;
  LeakyReLU 0.2) and a 1x1 conv head, logits or (``sigmoid_head``, the
  autoencoder's) probabilities.  SRGAN and FSRGAN use it at df 32.
* ``SRGANPaperDiscriminator``: the SRGAN paper's 4x4 stride-2 pyramid to
  32 df filters, 1x1 / 3x3 residual refinement and a 1x1 head; kernels
  N(0, 0.02), BN scales N(1, 0.02).
* ``ConditionalPatchDiscriminator``: pix2pix's D on concat(input,
  target): three 4x4 stride-2 blocks, a zero pad, 4x4 conv to 512, BN,
  LeakyReLU 0.3, a zero pad, 4x4 conv to 1 logit map (30x30 at 256).

Inputs and outputs are NHWC, as the Flax modules'; the heads return f32.
Strided SAME convolutions pad by lax's rule (models/layers.py::same_pads:
one more after than before where the total is odd).  Names mirror the
Flax scopes (``Conv_i``, ``BatchNorm_i`` in call order), so io/params.py
maps a Flax tree one to one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from denoise_gan_tpu_torch.models.layers import (
    BatchNorm, Conv, at_least_f32, gamma_normal02, leaky_relu, normal02,
)


def _nchw(x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    return x.to(dtype or x.dtype).permute(0, 3, 1, 2)


class PatchDiscriminator(nn.Module):
    """NHWC (N, H, W, 3) -> (N, ceil(H/16), ceil(W/16), 1) f32."""

    def __init__(self, df: int = 32, sigmoid_head: bool = False,
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.sigmoid_head = sigmoid_head
        spec = [(df, 1), (df, 2), (df, 1), (df, 2),
                (2 * df, 1), (2 * df, 2), (2 * df, 1), (2 * df, 2)]
        cin = 3
        for i, (filters, stride) in enumerate(spec):
            setattr(self, f"Conv_{i}", Conv(cin, filters, 3, stride=stride,
                                            dtype=dtype, generator=generator))
            if i:
                setattr(self, f"BatchNorm_{i - 1}",
                        BatchNorm(filters, momentum=0.8))
            cin = filters
        self.n_blocks = len(spec)
        setattr(self, f"Conv_{len(spec)}", Conv(cin, 1, 1, dtype=dtype,
                                                 generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _nchw(x, self.dtype)
        for i in range(self.n_blocks):
            x = getattr(self, f"Conv_{i}")(x)
            if i:
                x = getattr(self, f"BatchNorm_{i - 1}")(x)
            x = leaky_relu(x, 0.2)
        x = at_least_f32(getattr(self, f"Conv_{self.n_blocks}")(x))
        if self.sigmoid_head:
            x = torch.sigmoid(x)
        return x.permute(0, 2, 3, 1)


# SRGANPaperDiscriminator's blocks: (filters / df, kernel, stride, BN,
# LeakyReLU); the skip leaves block 7 and joins after block 10
PAPER_BLOCKS = [(1, 4, 2, False, True), (2, 4, 2, True, True),
                (4, 4, 2, True, True), (8, 4, 2, True, True),
                (16, 4, 2, True, True), (32, 4, 2, True, True),
                (16, 1, 1, True, True), (8, 1, 1, True, False),
                (2, 1, 1, True, True), (2, 3, 1, True, True),
                (8, 3, 1, True, False)]
PAPER_SKIP_FROM = 7


class SRGANPaperDiscriminator(nn.Module):
    """NHWC (N, H, W, 3) -> (N, ceil(H/64), ceil(W/64), 1) f32."""

    def __init__(self, df: int = 64, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        cin, bn = 3, 0
        for i, (mult, k, s, has_bn, _) in enumerate(PAPER_BLOCKS):
            setattr(self, f"Conv_{i}", Conv(
                cin, df * mult, k, stride=s, use_bias=not has_bn,
                kernel_init=normal02, dtype=dtype, generator=generator))
            if has_bn:
                setattr(self, f"BatchNorm_{bn}", BatchNorm(
                    df * mult, gamma_init=gamma_normal02,
                    generator=generator))
                bn += 1
            cin = df * mult
        setattr(self, f"Conv_{len(PAPER_BLOCKS)}", Conv(
            cin, 1, 1, kernel_init=normal02, dtype=dtype,
            generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _nchw(x, self.dtype)
        bn, skip = 0, None
        for i, (_, _, _, has_bn, lrelu) in enumerate(PAPER_BLOCKS):
            x = getattr(self, f"Conv_{i}")(x)
            if has_bn:
                x = getattr(self, f"BatchNorm_{bn}")(x)
                bn += 1
            if lrelu:
                x = leaky_relu(x, 0.2)
            if i == PAPER_SKIP_FROM:
                skip = x
        x = x + skip
        x = getattr(self, f"Conv_{len(PAPER_BLOCKS)}")(x)
        return at_least_f32(x).permute(0, 2, 3, 1)


class ConditionalPatchDiscriminator(nn.Module):
    """NHWC input and target (N, H, W, 3) each -> (N, H/8 - 2, W/8 - 2, 1)
    f32 logits."""

    def __init__(self, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype

        def conv(i, cin, cout, stride, padding, use_bias=False):
            setattr(self, f"Conv_{i}", Conv(
                cin, cout, 4, stride=stride, padding=padding,
                use_bias=use_bias, kernel_init=normal02, dtype=dtype,
                generator=generator))

        conv(0, 6, 64, 2, "SAME")
        conv(1, 64, 128, 2, "SAME")
        self.BatchNorm_0 = BatchNorm(128)
        conv(2, 128, 256, 2, "SAME")
        self.BatchNorm_1 = BatchNorm(256)
        conv(3, 256, 512, 1, "VALID")
        self.BatchNorm_2 = BatchNorm(512)
        conv(4, 512, 1, 1, "VALID", use_bias=True)

    def forward(self, inp: torch.Tensor, tar: torch.Tensor) -> torch.Tensor:
        x = _nchw(torch.cat([inp, tar], dim=-1), self.dtype)
        # Keras LeakyReLU's default alpha, 0.3
        x = leaky_relu(self.Conv_0(x), 0.3)
        x = leaky_relu(self.BatchNorm_0(self.Conv_1(x)), 0.3)
        x = leaky_relu(self.BatchNorm_1(self.Conv_2(x)), 0.3)
        x = self.Conv_3(F.pad(x, (1, 1, 1, 1)))
        x = leaky_relu(self.BatchNorm_2(x), 0.3)
        x = self.Conv_4(F.pad(x, (1, 1, 1, 1)))
        return at_least_f32(x).permute(0, 2, 3, 1)
