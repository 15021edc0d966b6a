"""The losses in PyTorch (denoise_gan_tpu/losses/gan.py:15-77): the
adversarial BCE from logits and from probabilities, L1, L2, total
variation and the VGG content loss, all reduced in f32 (float64 inputs
in float64, a precision reference).
"""

from __future__ import annotations

import torch

from denoise_gan_tpu_torch.models.layers import at_least_f32
from denoise_gan_tpu_torch.models.vgg import content_features
from denoise_gan_tpu_torch.ops.image import total_variation

KERAS_EPS = 1e-7     # Keras BinaryCrossentropy's probability clip


def bce_logits(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Mean BCE from logits, the stable form max(l, 0) - l z +
    log(1 + exp(-|l|))."""
    logits, labels = at_least_f32(logits), at_least_f32(labels)
    per = (torch.clamp(logits, min=0.0) - logits * labels
           + torch.log1p(torch.exp(-logits.abs())))
    return per.mean()


def bce_probs(labels: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Mean BCE of probabilities clipped to [eps, 1 - eps], as Keras."""
    p = torch.clamp(at_least_f32(probs), KERAS_EPS, 1.0 - KERAS_EPS)
    labels = at_least_f32(labels)
    return (-(labels * torch.log(p)
              + (1.0 - labels) * torch.log(1.0 - p))).mean()


def adversarial_loss(disc_fake: torch.Tensor,
                     from_logits: bool = True) -> torch.Tensor:
    """The generator's adversarial term BCE(1, D(fake))."""
    fn = bce_logits if from_logits else bce_probs
    return fn(torch.ones_like(disc_fake), disc_fake)


def discriminator_loss(disc_real: torch.Tensor, disc_fake: torch.Tensor,
                       from_logits: bool = True,
                       half: bool = False) -> torch.Tensor:
    """BCE(1, D(real)) + BCE(0, D(fake)); `half` (FSRGAN) halves it."""
    fn = bce_logits if from_logits else bce_probs
    loss = (fn(torch.ones_like(disc_real), disc_real)
            + fn(torch.zeros_like(disc_fake), disc_fake))
    return 0.5 * loss if half else loss


def l1_loss(target: torch.Tensor, output: torch.Tensor) -> torch.Tensor:
    return (at_least_f32(target) - at_least_f32(output)).abs().mean()


def l2_loss(target: torch.Tensor, output: torch.Tensor) -> torch.Tensor:
    return (at_least_f32(target) - at_least_f32(output)).square().mean()


def tv_loss(target: torch.Tensor, output: torch.Tensor) -> torch.Tensor:
    """The batch mean of tf.image.total_variation(target - output)."""
    return total_variation(at_least_f32(target)
                           - at_least_f32(output)).mean()


def content_loss(vgg, target: torch.Tensor, output: torch.Tensor
                 ) -> torch.Tensor:
    """MSE of the block5_conv4 features / 12.75 (models/vgg.py)."""
    return l2_loss(content_features(vgg, target),
                   content_features(vgg, output))
