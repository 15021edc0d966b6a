"""JPEG compression artifacts on the device, the training's noise model
(denoise_gan_tpu/ops/jpeg.py), in PyTorch.

JPEG's entropy coding is lossless, so a round trip's artifacts come from:
RGB -> YCbCr, 4:2:0 chroma subsampling (a 2x2 box average), the 8x8 block
DCT, quantisation by the quality-scaled Annex K tables (libjpeg's
jpeg_quality_scaling), dequantisation, the inverse DCT, the chroma
upsample (libjpeg's "fancy" triangle filter, which is half-pixel bilinear)
and YCbCr -> RGB.  Each is a dense tensor op; the DCTs are products with
the orthonormal 8x8 DCT-II matrix.  Quantisation rounds half to even
(torch.round, as jnp.round).  A coefficient that lands on a rounding
boundary can flip a whole step between two summation orders, so the port
and the JAX package agree on all but a small share of values.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from denoise_gan_tpu_torch.ops.image import resize_axes
from denoise_gan_tpu_torch.utils.device import no_tf32

LUMA_BASE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float32)

CHROMA_BASE = np.full((8, 8), 99, dtype=np.float32)
CHROMA_BASE[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                       [24, 26, 56, 99], [47, 66, 99, 99]]

RANDOM_QUALITY = (25, 75)      # random_jpeg_quality's default range


def dct_matrix() -> np.ndarray:
    """The orthonormal 8-point DCT-II matrix D (coefficients = D @ block @
    D.T), computed in float64 and rounded to f32, as the JAX package's."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    c = np.where(u == 0, np.sqrt(1.0 / 8.0), np.sqrt(2.0 / 8.0))
    return (c * np.cos((2 * x + 1) * u * np.pi / 16.0)).astype(np.float32)


def quality_to_tables(quality, device=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """libjpeg's jpeg_quality_scaling of the base tables: quality (a
    number or a tensor of per-image qualities) clipped to [1, 100], scale
    5000 / q below 50 and 200 - 2 q from 50, each entry floor((base *
    scale + 50) / 100) clipped to [1, 255].  (..., 8, 8) f32 each."""
    q = torch.as_tensor(quality, dtype=torch.float32, device=device)
    q = torch.clamp(q, 1.0, 100.0)
    scale = torch.where(q < 50.0, 5000.0 / q, 200.0 - 2.0 * q)[..., None,
                                                                None]

    def scale_tbl(base):
        b = torch.from_numpy(base).to(q.device)
        return torch.clamp(torch.floor((b * scale + 50.0) / 100.0),
                           1.0, 255.0)

    return scale_tbl(LUMA_BASE), scale_tbl(CHROMA_BASE)


def rgb_to_ycbcr(rgb255: torch.Tensor) -> torch.Tensor:
    """JFIF full-range RGB -> YCbCr of [0, 255] values, channels last."""
    r, g, b = rgb255.unbind(-1)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return torch.stack([y, cb, cr], dim=-1)


def ycbcr_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    y, cb, cr = ycc[..., 0], ycc[..., 1] - 128.0, ycc[..., 2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return torch.stack([r, g, b], dim=-1)


def _blockwise_quantize(plane: torch.Tensor, table: torch.Tensor
                        ) -> torch.Tensor:
    """8x8 block DCT -> quantise -> dequantise -> inverse DCT of a (N, H,
    W) plane; `table` is (8, 8) or, per image, (N, 8, 8)."""
    n, h, w = plane.shape
    blocks = plane.reshape(n, h // 8, 8, w // 8, 8).transpose(2, 3)
    blocks = blocks - 128.0
    d = torch.from_numpy(dct_matrix()).to(plane.device)
    if table.dim() == 3:
        table = table[:, None, None]
    with no_tf32():
        coeff = d @ blocks @ d.T
        coeff = torch.round(coeff / table) * table
        out = d.T @ coeff @ d
    out = out + 128.0
    return out.transpose(2, 3).reshape(n, h, w)


def _downsample2x(plane: torch.Tensor) -> torch.Tensor:
    """The encoder's chroma downsample: 2x2 box average."""
    n, h, w = plane.shape
    return plane.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


def _upsample2x(plane: torch.Tensor) -> torch.Tensor:
    """The decoder's chroma upsample: half-pixel bilinear (jax.image.resize
    'linear', no antialias)."""
    h, w = plane.shape[-2:]
    return resize_axes(plane, {-2: 2 * h, -1: 2 * w}, "linear")


def jpeg_roundtrip(rgb01: torch.Tensor, quality,
                   chroma_subsample: bool = True) -> torch.Tensor:
    """JPEG-compress then decompress a [0, 1] RGB image (HWC or NHWC, f32).
    `quality`: a number, or a tensor with one quality per image.  The
    image is edge-padded to the MCU (16 with chroma subsampling, else 8)
    and cropped back."""
    squeeze = rgb01.dim() == 3
    if squeeze:
        rgb01 = rgb01[None]
    n, h, w, _ = rgb01.shape
    mult = 16 if chroma_subsample else 8
    ph, pw = (-h) % mult, (-w) % mult
    x = rgb01.float()
    if ph or pw:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                  mode="replicate").permute(0, 2, 3, 1)

    luma_t, chroma_t = quality_to_tables(quality, device=x.device)
    ycc = rgb_to_ycbcr(x * 255.0)
    y = _blockwise_quantize(ycc[..., 0], luma_t)
    if chroma_subsample:
        cb, cr = (_upsample2x(_blockwise_quantize(
            _downsample2x(ycc[..., i]), chroma_t)) for i in (1, 2))
    else:
        cb, cr = (_blockwise_quantize(ycc[..., i], chroma_t) for i in (1, 2))

    # the decoder clamps each component to [0, 255] before the colour
    # conversion
    ycc_out = torch.clamp(torch.stack([y, cb, cr], dim=-1), 0.0, 255.0)
    out = torch.clamp(ycbcr_to_rgb(ycc_out), 0.0, 255.0) / 255.0
    out = out[:, :h, :w, :]
    return out[0] if squeeze else out


def random_qualities(n: int, generator: torch.Generator | None = None,
                     device=None, min_quality: int = RANDOM_QUALITY[0],
                     max_quality: int = RANDOM_QUALITY[1]) -> torch.Tensor:
    """n qualities drawn uniformly from [min_quality, max_quality] by
    `generator` (on `device`), f32."""
    return torch.randint(min_quality, max_quality + 1, (n,),
                         generator=generator, device=device).float()


def random_jpeg_quality(rgb01: torch.Tensor,
                        generator: torch.Generator | None = None,
                        min_quality: int = RANDOM_QUALITY[0],
                        max_quality: int = RANDOM_QUALITY[1]
                        ) -> torch.Tensor:
    """Each image of an NHWC batch at its own random quality."""
    q = random_qualities(rgb01.shape[0], generator, rgb01.device,
                         min_quality, max_quality)
    return jpeg_roundtrip(rgb01, q)
