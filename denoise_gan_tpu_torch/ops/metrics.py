"""Quality metrics PSNR and SSIM (denoise_gan_tpu/ops/metrics.py:15-67),
with tf.image.psnr / tf.image.ssim's semantics: an 11x11 Gaussian window
of sigma 1.5, k1 = 0.01, k2 = 0.03, VALID, in f32 (TF32 off on the card).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from denoise_gan_tpu_torch.utils.device import no_tf32


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0
         ) -> torch.Tensor:
    """Per-image PSNR of NHWC batches, shape (N,)."""
    mse = (a.float() - b.float()).square().mean(dim=(1, 2, 3))
    return 10.0 * torch.log10((max_val * max_val) / mse.clamp(min=1e-12))


def gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """(size, size) f32 Gaussian summing to 1 (metrics.py::_fspecial_gauss)."""
    coords = np.arange(size, dtype=np.float32) - np.float32((size - 1) / 2.0)
    g = np.exp(-(coords ** 2) / np.float32(2.0 * sigma ** 2))
    g = np.outer(g, g)
    return (g / g.sum()).astype(np.float32)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0,
         filter_size: int = 11, filter_sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Per-image mean SSIM of NHWC batches, shape (N,): Gaussian-windowed
    local statistics by a grouped VALID convolution, luminance times
    contrast-structure, averaged over space and channels."""
    a = a.float().permute(0, 3, 1, 2)
    b = b.float().permute(0, 3, 1, 2)
    c = a.shape[1]
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    win = torch.from_numpy(gaussian_window(filter_size, filter_sigma)).to(
        a.device).expand(c, 1, filter_size, filter_size)

    def blur(x):
        return F.conv2d(x, win, groups=c)

    with no_tf32():
        mu_a, mu_b = blur(a), blur(b)
        mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
        sigma_aa = blur(a * a) - mu_aa
        sigma_bb = blur(b * b) - mu_bb
        sigma_ab = blur(a * b) - mu_ab
    luminance = (2.0 * mu_ab + c1) / (mu_aa + mu_bb + c1)
    cs = (2.0 * sigma_ab + c2) / (sigma_aa + sigma_bb + c2)
    return (luminance * cs).mean(dim=(1, 2, 3))
