"""Model registry (denoise_gan_tpu/models/__init__.py:33-73): the
generators of the four families."""

from __future__ import annotations

import torch

from denoise_gan_tpu_torch.models.autoencoder import AutoencoderGenerator
from denoise_gan_tpu_torch.models.fsrgan import FSRGANGenerator
from denoise_gan_tpu_torch.models.pix2pix import Pix2PixGenerator
from denoise_gan_tpu_torch.models.srgan import SRGANGenerator
from denoise_gan_tpu_torch.utils.device import resolve_device

FAMILIES = ("autoencoder", "pix2pix", "srgan", "fsrgan")


def build_generator(family: str, dtype: torch.dtype | None = None,
                    device: torch.device | str = "cuda",
                    generator: torch.Generator | None = None,
                    scale: int = 4):
    """The family's generator in eval mode on `device` (the card unless the
    caller asks for the CPU; without a GPU a CUDA request raises
    RuntimeError), initialised from `generator` (a CPU torch.Generator; None
    uses torch's global one).
    `dtype` is the compute dtype (None: f32); parameters are f32.  SRGAN is
    the 16-block, 64-filter generator at `scale` (2 or 4: scale // 2
    pixel-shuffle stages), FSRGAN always 4x, the autoencoder and pix2pix 1x
    (`scale` unused), as the JAX registry builds them.  An unknown family
    raises ValueError."""
    if family not in FAMILIES:
        raise ValueError(f"unknown model family: {family!r}")
    dev = resolve_device(device)
    if family == "autoencoder":
        model = AutoencoderGenerator(dtype=dtype, generator=generator)
    elif family == "pix2pix":
        model = Pix2PixGenerator(dtype=dtype, generator=generator)
    elif family == "fsrgan":
        model = FSRGANGenerator(gf=32, dtype=dtype, generator=generator)
    else:
        if scale not in (2, 4):
            raise ValueError(f"SRGAN scale must be 2 or 4, got {scale}")
        model = SRGANGenerator(scale=scale, dtype=dtype, generator=generator)
    return model.to(dev).eval()
