"""Model registry (denoise_gan_tpu/models/__init__.py:22-76): the
generators of the four families, and each family's bundle for training
(generator, discriminator and their GAN wiring)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from denoise_gan_tpu_torch.models.autoencoder import AutoencoderGenerator
from denoise_gan_tpu_torch.models.discriminators import (
    ConditionalPatchDiscriminator, PatchDiscriminator, SRGANPaperDiscriminator,
)
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


@dataclass(frozen=True)
class ModelBundle:
    """A family's nets and wiring, as the JAX package's ModelBundle; the
    nets are built by ``build_generator_net`` / ``build_discriminator``
    (train/state.py builds both from one seed).  `dtype` is the compute
    dtype (bf16 where ``fp16``, else None: f32); parameters stay f32."""

    name: str
    scale: int
    dtype: torch.dtype | None
    disc_variant: str
    conditional_disc: bool      # pix2pix: D(input, target)
    disc_sigmoid: bool          # autoencoder: D outputs probabilities
    upscales: bool              # srgan / fsrgan change the resolution

    def build_generator_net(self, device: torch.device | str = "cuda",
                            generator: torch.Generator | None = None):
        return build_generator(self.name, dtype=self.dtype, device=device,
                               generator=generator, scale=self.scale)

    def build_discriminator(self, device: torch.device | str = "cuda",
                            generator: torch.Generator | None = None):
        """The family's discriminator in eval mode on `device`."""
        dev = resolve_device(device)
        if self.name == "pix2pix":
            disc = ConditionalPatchDiscriminator(self.dtype, generator)
        elif self.name == "srgan" and self.disc_variant == "paper":
            disc = SRGANPaperDiscriminator(64, self.dtype, generator)
        else:
            disc = PatchDiscriminator(32, self.disc_sigmoid, self.dtype,
                                      generator)
        return disc.to(dev).eval()


def build_models(family: str, scale: int = 4, fp16: bool = False,
                 disc_variant: str = "fast") -> ModelBundle:
    """The family's bundle: autoencoder (sigmoid PatchDiscriminator, 1x),
    pix2pix (conditional D, 1x), srgan (`scale`; PatchDiscriminator, or
    the paper's with ``disc_variant="paper"``) and fsrgan (4x).  `fp16`
    selects bf16 compute.  An unknown family raises ValueError."""
    if family not in FAMILIES:
        raise ValueError(f"unknown model family: {family!r}")
    return ModelBundle(
        name=family, scale=scale if family == "srgan" else
        (4 if family == "fsrgan" else 1),
        dtype=torch.bfloat16 if fp16 else None, disc_variant=disc_variant,
        conditional_disc=family == "pix2pix",
        disc_sigmoid=family == "autoencoder",
        upscales=family in ("srgan", "fsrgan"))
