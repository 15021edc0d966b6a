"""Pixel shuffle in TF channel order (denoise_gan_tpu/ops/image.py:21-29).

The input channel of ``depth_to_space`` is ``(dy*block + dx)*C + c``, as in
tf.nn.depth_to_space.  ``torch.nn.PixelShuffle`` uses ``c*block**2 + ...``
instead, so it is not a drop-in replacement.
"""

from __future__ import annotations

import torch


def depth_to_space(x: torch.Tensor, block: int) -> torch.Tensor:
    """NHWC (N, H, W, b*b*C) -> (N, H*b, W*b, C), TF channel order."""
    n, h, w, c = x.shape
    co = c // (block * block)
    x = x.reshape(n, h, w, block, block, co).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * block, w * block, co)


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """Inverse of :func:`depth_to_space`: NHWC (N, H*b, W*b, C) ->
    (N, H, W, b*b*C)."""
    n, hb, wb, c = x.shape
    h, w = hb // block, wb // block
    x = x.reshape(n, h, block, w, block, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h, w, block * block * c)


def depth_to_space_nchw(x: torch.Tensor, block: int) -> torch.Tensor:
    """:func:`depth_to_space` on an NCHW tensor.  Runs in NHWC, so a
    channels_last input gives a channels_last output."""
    return depth_to_space(x.permute(0, 2, 3, 1), block).permute(0, 3, 1, 2)
