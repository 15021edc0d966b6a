"""Image ops (denoise_gan_tpu/ops/image.py): pixel shuffle in TF channel
order, the bicubic resize and the centre crop or pad.

The input channel of ``depth_to_space`` is ``(dy*block + dx)*C + c``, as in
tf.nn.depth_to_space.  ``torch.nn.PixelShuffle`` uses ``c*block**2 + ...``
instead, so it is not a drop-in replacement.

``resize_bicubic`` is ``jax.image.resize(method="cubic",
antialias=False)``: the Keys kernel with a = -0.5 at half-pixel centres,
where taps outside the image are dropped and the rest renormalised.
``torch.nn.functional.interpolate(mode="bicubic")`` takes a = -0.75 and
clamps indices at the border, so it computes another function.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from denoise_gan_tpu_torch.utils.device import no_tf32


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


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel (a = -0.5) at distances x >= 0, in x's dtype
    (jax/_src/image/scale.py::_fill_keys_cubic_kernel)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def bicubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 weights of one axis, as JAX computes them in f32
    (jax/_src/image/scale.py::compute_weight_mat, no antialias, no
    translation): column j samples the input at (j + 0.5) * n_in / n_out -
    0.5; its weights are renormalised to sum to 1 over the taps inside the
    image, and zero where the sample lies outside it."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = _keys_cubic(x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


@functools.lru_cache(maxsize=16)
def _bicubic_matrix(n_in: int, n_out: int, device: torch.device,
                    dtype: torch.dtype) -> torch.Tensor:
    """bicubic_weights on `device` in `dtype`, cached: a video scores every
    frame at one size, 1920 -> 7680 takes ~0.4 s of host time to build, and
    its 59 MB would otherwise cross to the card for every frame."""
    return torch.from_numpy(bicubic_weights(n_in, n_out)).to(device, dtype)


def resize_bicubic(image: torch.Tensor, height: int, width: int
                   ) -> torch.Tensor:
    """Bicubic resize of a float HWC or NHWC image to (height, width), as
    ``jax.image.resize(method="cubic", antialias=False)`` (see the module
    docstring): one product with each changed axis's weights, in the
    image's dtype, TF32 off."""
    out = image
    with no_tf32():
        for axis, n in ((image.ndim - 3, height), (image.ndim - 2, width)):
            if out.shape[axis] == n:
                continue
            w = _bicubic_matrix(out.shape[axis], n, out.device, out.dtype)
            out = torch.tensordot(out, w, dims=([axis], [0])).movedim(-1,
                                                                     axis)
    return out


def resize_with_crop_or_pad(image: torch.Tensor, th: int, tw: int
                            ) -> torch.Tensor:
    """tf.image.resize_with_crop_or_pad of an HWC or NHWC image: a centre
    crop at offset (h - th) // 2, then a zero pad of (th - h) // 2 before
    and the rest after, per axis."""
    ha, wa = image.ndim - 3, image.ndim - 2
    h, w = image.shape[ha], image.shape[wa]
    if h > th:
        image = image.narrow(ha, (h - th) // 2, th)
    if w > tw:
        image = image.narrow(wa, (w - tw) // 2, tw)
    ph, pw = th - image.shape[ha], tw - image.shape[wa]
    if ph > 0 or pw > 0:
        ph, pw = max(ph, 0), max(pw, 0)
        image = F.pad(image, (0, 0, pw // 2, pw - pw // 2,
                              ph // 2, ph - ph // 2))
    return image
