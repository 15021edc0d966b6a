"""Model registry (denoise_gan_tpu/models/__init__.py:33-73).  The FSRGAN
and SRGAN generators are ported so far."""

from __future__ import annotations

import torch

from denoise_gan_tpu_torch.models.fsrgan import FSRGANGenerator
from denoise_gan_tpu_torch.models.srgan import SRGANGenerator
from denoise_gan_tpu_torch.utils.device import resolve_device


def build_generator(family: str, dtype: torch.dtype | None = None,
                    device: torch.device | str = "cuda",
                    generator: torch.Generator | None = None):
    """The family's generator in eval mode on `device` (the card unless the
    caller asks for the CPU; without a GPU a CUDA request raises
    RuntimeError), initialised from `generator` (a CPU torch.Generator; None
    uses torch's global one).
    `dtype` is the compute dtype (None: f32); parameters are f32.  SRGAN is
    the 4x, 16-block, 64-filter generator the JAX registry builds."""
    dev = resolve_device(device)
    if family == "fsrgan":
        model = FSRGANGenerator(gf=32, dtype=dtype, generator=generator)
    elif family == "srgan":
        model = SRGANGenerator(scale=4, dtype=dtype, generator=generator)
    else:
        raise NotImplementedError(f"model family {family!r} is not ported "
                                  "yet")
    return model.to(dev).eval()
