"""Model registry (denoise_gan_tpu/models/__init__.py:33-73).  Only the
FSRGAN generator is ported so far."""

from __future__ import annotations

import torch

from denoise_gan_tpu_torch.models.fsrgan import FSRGANGenerator
from denoise_gan_tpu_torch.utils.device import resolve_device


def build_generator(family: str, dtype: torch.dtype | None = None,
                    device: torch.device | str = "cpu",
                    generator: torch.Generator | None = None):
    """The family's generator in eval mode on `device`, initialised from
    `generator` (a CPU torch.Generator; None uses torch's global one).
    `dtype` is the compute dtype (None: f32); parameters are f32."""
    dev = resolve_device(device)
    if family == "fsrgan":
        model = FSRGANGenerator(gf=32, dtype=dtype, generator=generator)
        return model.to(dev).eval()
    raise NotImplementedError(f"model family {family!r} is not ported yet")
