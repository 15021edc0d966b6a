"""Image ops (denoise_gan_tpu/ops/image.py): pixel shuffle in TF channel
order, the bicubic (and JPEG's bilinear) resize, the centre crop or pad,
and the training's losses and image panels: total variation, Sobel edges,
first differences, renorm / autoscale / to_uint8, the reference's
non-overlapping patch helpers and the Laplacian.  Images are NHWC.

The input channel of ``depth_to_space`` is ``(dy*block + dx)*C + c``, as in
tf.nn.depth_to_space.  ``torch.nn.PixelShuffle`` uses ``c*block**2 + ...``
instead, so it is not a drop-in replacement.

``resize_bicubic`` is ``jax.image.resize(method="cubic",
antialias=False)``: the Keys kernel with a = -0.5 at half-pixel centres,
where taps outside the image are dropped and the rest renormalised.
``torch.nn.functional.interpolate(mode="bicubic")`` takes a = -0.75 and
clamps indices at the border, so it computes another function.

``resize_bicubic_tf`` is TensorFlow 2's ``tf.image.resize(method=
"bicubic")`` (antialias=False): the ResizeBicubic kernel with half-pixel
centres, the Keys kernel (a = -0.5) read from its 1024-step table, taps
outside the image dropped and the rest renormalised, in f32, rows first.
It never antialiases, where ``jax.image.resize`` would on a downscale with
antialias=True.
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


def _triangle(x: np.ndarray) -> np.ndarray:
    """The linear kernel max(0, 1 - |x|) (jax/_src/image/scale.py::
    _fill_triangle_kernel)."""
    return np.maximum(0.0, 1.0 - np.abs(x))


KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


def resize_weights(n_in: int, n_out: int, method: str = "cubic"
                   ) -> np.ndarray:
    """(n_in, n_out) f32 weights of one axis, as JAX computes them in f32
    (jax/_src/image/scale.py::compute_weight_mat, no antialias, no
    translation): column j samples the input at (j + 0.5) * n_in / n_out -
    0.5; its weights are renormalised to sum to 1 over the taps inside the
    image, and zero where the sample lies outside it."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = KERNELS[method](x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


@functools.lru_cache(maxsize=16)
def _resize_matrix(n_in: int, n_out: int, device: torch.device,
                   dtype: torch.dtype, method: str = "cubic") -> torch.Tensor:
    """resize_weights on `device` in `dtype`, cached: a video scores every
    frame at one size, 1920 -> 7680 takes ~0.4 s of host time to build, and
    its 59 MB would otherwise cross to the card for every frame."""
    return torch.from_numpy(resize_weights(n_in, n_out, method)).to(
        device, dtype)


def resize_axes(x: torch.Tensor, sizes: dict[int, int],
                method: str = "cubic") -> torch.Tensor:
    """``jax.image.resize`` (antialias=False) of the axes in `sizes` (axis
    -> new size), one product with each changed axis's weights in turn, in
    x's dtype, TF32 off."""
    out = x
    with no_tf32():
        for axis, n in sizes.items():
            axis %= x.ndim
            if out.shape[axis] == n:
                continue
            w = _resize_matrix(out.shape[axis], n, out.device, out.dtype,
                               method)
            out = torch.tensordot(out, w, dims=([axis], [0])).movedim(-1,
                                                                     axis)
    return out


def resize_bicubic(image: torch.Tensor, height: int, width: int
                   ) -> torch.Tensor:
    """Bicubic resize of a float HWC or NHWC image to (height, width), as
    ``jax.image.resize(method="cubic", antialias=False)`` (see the module
    docstring)."""
    return resize_axes(image, {image.ndim - 3: height, image.ndim - 2: width})


TF_TABLE_SIZE = 1024     # tensorflow/core/kernels/image/resize_bicubic_op.cc


@functools.lru_cache(maxsize=1)
def _tf_cubic_table() -> np.ndarray:
    """ResizeBicubic's (1025, 2) f32 table of the Keys kernel (a = -0.5)
    at x = i / 1024 and at x + 1, computed in double as its
    InitCoeffsTable."""
    a = -0.5
    x = np.arange(TF_TABLE_SIZE + 1, dtype=np.float64) / TF_TABLE_SIZE
    near = ((a + 2) * x - (a + 3)) * x * x + 1
    x = x + 1.0
    far = ((a * x - 5 * a) * x + 8 * a) * x - 4 * a
    return np.stack([near, far], axis=1).astype(np.float32)


def _tf_bicubic_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """(indices, weights), each (n_out, 4), of one axis of ResizeBicubic
    with half-pixel centres, in its f32 arithmetic (GetWeightsAndIndices
    with the Keys table): the sample (j + 0.5) * (n_in / n_out) - 0.5, the
    table row lrintf(frac * 1024), taps outside the image weighted 0, the
    weights renormalised by their sum."""
    f32 = np.float32
    table = _tf_cubic_table()
    scale = f32(n_in) / f32(n_out)
    x = (np.arange(n_out, dtype=f32) + f32(0.5)) * scale - f32(0.5)
    loc = np.floor(x)
    offset = np.rint((x - loc) * f32(TF_TABLE_SIZE)).astype(np.int64)
    loc = loc.astype(np.int64)
    w = np.stack([table[offset, 1], table[offset, 0],
                  table[TF_TABLE_SIZE - offset, 0],
                  table[TF_TABLE_SIZE - offset, 1]], axis=1)
    idx = loc[:, None] + np.arange(-1, 3)
    w = np.where((idx >= 0) & (idx < n_in), w, f32(0)).astype(f32)
    total = ((w[:, 0] + w[:, 1]) + w[:, 2]) + w[:, 3]
    ok = np.abs(total) >= f32(1000.0) * np.finfo(f32).tiny
    inv = f32(1.0) / np.where(ok, total, f32(1.0))
    w = np.where(ok[:, None], w * inv[:, None], w).astype(f32)
    return np.clip(idx, 0, n_in - 1), w


def _tf_axis(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """One axis of ResizeBicubic: each output the four taps' weighted sum,
    added in the kernel's order."""
    idx, w = _tf_bicubic_taps(x.shape[axis], n)
    idx = torch.from_numpy(idx).to(x.device)
    w = torch.from_numpy(w).to(x.device, x.dtype)
    shape = [1] * x.ndim
    shape[axis] = n
    out = None
    for k in range(4):
        term = x.index_select(axis, idx[:, k]) * w[:, k].reshape(shape)
        out = term if out is None else out + term
    return out


def resize_bicubic_tf(image: torch.Tensor, height: int, width: int
                      ) -> torch.Tensor:
    """``tf.image.resize(image, (height, width), method="bicubic")`` of a
    float HWC or NHWC image, in f32 (see the module docstring)."""
    x = image.float()
    x = _tf_axis(x, x.ndim - 3, height)
    return _tf_axis(x, x.ndim - 2, width)


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


def pixel_shuffle(x: torch.Tensor, upscale: int = 2) -> torch.Tensor:
    """Alias of depth_to_space, as the JAX package's."""
    return depth_to_space(x, upscale)


# --- gradient / variation diagnostics and the TV loss ----------------------

SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def _per_channel_conv(image: torch.Tensor, kernels: torch.Tensor,
                      pad_mode: str) -> torch.Tensor:
    """Each channel of NHWC `image`, padded by 1 (`pad_mode`), correlated
    with each of the (K, 3, 3) kernels, in f32 with TF32 off: (N, H, W, C,
    K)."""
    n, h, w, c = image.shape
    x = F.pad(image.float().permute(0, 3, 1, 2), (1, 1, 1, 1),
              mode=pad_mode)
    k = kernels.to(x.device, torch.float32)
    weight = k[None].expand(c, -1, 3, 3).reshape(c * k.shape[0], 1, 3, 3)
    with no_tf32():
        out = F.conv2d(x, weight, groups=c)
    return out.permute(0, 2, 3, 1).reshape(n, h, w, c, k.shape[0])


def sobel_edges(image: torch.Tensor) -> torch.Tensor:
    """tf.image.sobel_edges: NHWC -> (N, H, W, C, 2), [grad_y, grad_x],
    REFLECT padding."""
    ky = torch.tensor(SOBEL_Y)
    return _per_channel_conv(image, torch.stack([ky, ky.T]), "reflect")


def sobel_variation(image: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude of a [-1, 1] image (the training panels)."""
    sob = sobel_edges(torch.clamp((image + 1.0) / 2.0, 0.0, 1.0))
    dy, dx = sob[..., 0] / 4.0, sob[..., 1] / 4.0
    return torch.sqrt(dx.square() + dy.square())


def high_pass_x_y(image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """First differences along W and H, cropped to a common shape."""
    x_var = image[:, :, 1:, :] - image[:, :, :-1, :]
    y_var = image[:, 1:, :, :] - image[:, :-1, :, :]
    return x_var[:, :-1, :, :], y_var[:, :, :-1, :]


def total_variation_map(image: torch.Tensor) -> torch.Tensor:
    """|dx| + |dy| (a panel)."""
    dx, dy = high_pass_x_y(image)
    return dx.abs() + dy.abs()


def total_variation(image: torch.Tensor) -> torch.Tensor:
    """tf.image.total_variation: per image, the sum of absolute
    differences along H and W over H, W and C; shape (N,)."""
    dh = (image[:, 1:, :, :] - image[:, :-1, :, :]).abs()
    dw = (image[:, :, 1:, :] - image[:, :, :-1, :]).abs()
    return dh.sum(dim=(1, 2, 3)) + dw.sum(dim=(1, 2, 3))


def renorm(image: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1], clipped."""
    return torch.clamp((image + 1.0) / 2.0, 0.0, 1.0)


def autoscale(image: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Min/max rescale to [0, scale] over the whole tensor."""
    lo = image.min()
    return scale * (image - lo) / (image.max() - lo + 1e-12)


def to_uint8(image: torch.Tensor, norm: bool = True) -> torch.Tensor:
    """A uint8 panel: renorm of a [-1, 1] image (norm) or autoscale, times
    255, truncated as XLA's float -> uint8 conversion."""
    image = renorm(image) if norm else autoscale(image)
    return (255.0 * image).to(torch.uint8)


# --- the reference's non-overlapping tiling ---------------------------------

def im2patch(img: torch.Tensor, crop: int = 256) -> torch.Tensor:
    """NHWC (1, H, W, C) -> (H*W/crop^2, crop, crop, C), non-overlapping,
    by space_to_depth as the JAX package's."""
    c = img.shape[-1]
    return space_to_depth(img, crop).reshape(-1, crop, crop, c)


def patch2im(imgs: torch.Tensor, patch_shape=(4, 4)) -> torch.Tensor:
    """Inverse of im2patch for a (N, crop, crop, C) batch laid out over a
    patch_shape grid."""
    crop = imgs.shape[1]
    return depth_to_space(
        imgs.reshape(1, patch_shape[0], patch_shape[1], -1), crop)


LAPLACIAN = ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0))


def laplacian(image: torch.Tensor) -> torch.Tensor:
    """3x3 Laplacian per channel (cv2.Laplacian CV_32F), REPLICATE border,
    HWC or NHWC, f32."""
    sq = image.dim() == 3
    x = image[None] if sq else image
    out = _per_channel_conv(x, torch.tensor(LAPLACIAN)[None],
                            "replicate")[..., 0]
    return out[0] if sq else out
