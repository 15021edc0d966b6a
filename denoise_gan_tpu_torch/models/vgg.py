"""VGG19 perceptual features in PyTorch, frozen, up to block5_conv4
(denoise_gan_tpu/models/vgg.py:23-108).

``preprocess`` is keras.applications.vgg19.preprocess_input (caffe mode)
of a [-1, 1] image: to [0, 255], RGB -> BGR, minus the ImageNet BGR means.
``content_features`` divides block5_conv4's activations by 12.75, the
content loss's feature map.  Weights come from the ``.npz`` the JAX package
reads (keys ``conv{b}_{c}/kernel`` (HWIO) and ``conv{b}_{c}/bias``, at
``VGG19_WEIGHTS`` or ``models/vgg19_notop.npz``); without it, from a
fixed-seed numpy draw of the port's own (LeCun normal kernels, zero
biases, numpy seed 42), with the JAX package's warning.  That draw is not
Flax's, so the tests carry the JAX package's VGG parameters across.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from denoise_gan_tpu_torch.io.params import from_jax_params
from denoise_gan_tpu_torch.models.layers import Conv, at_least_f32

# (block, conv in block, filters) for conv1_1 .. conv5_4
VGG19_CFG = [
    (1, 1, 64), (1, 2, 64),
    (2, 1, 128), (2, 2, 128),
    (3, 1, 256), (3, 2, 256), (3, 3, 256), (3, 4, 256),
    (4, 1, 512), (4, 2, 512), (4, 3, 512), (4, 4, 512),
    (5, 1, 512), (5, 2, 512), (5, 3, 512), (5, 4, 512),
]
BGR_MEAN = (103.939, 116.779, 123.68)
FEATURE_SCALE = 12.75
INIT_SEED = 42


def preprocess(img_m11: torch.Tensor) -> torch.Tensor:
    """NHWC [-1, 1] RGB -> caffe BGR, mean-subtracted, f32."""
    x = ((at_least_f32(img_m11) + 1.0) * 255.0) / 2.0
    x = x.flip(-1)
    return x - torch.tensor(BGR_MEAN, dtype=x.dtype, device=x.device)


def _unset(w: torch.Tensor, generator=None) -> None:
    """Leaves a kernel for init_vgg_params to fill."""
    w.zero_()


class VGG19Features(nn.Module):
    """The 16 3x3 ReLU convs through block5_conv4 (f32), a 2x2 max pool
    after blocks 1-4.  NHWC in and out; ``conv{b}_{c}.weight`` / ``.bias``
    mirror the Flax scopes."""

    def __init__(self):
        super().__init__()
        cin = 3
        for block, conv, filters in VGG19_CFG:
            setattr(self, f"conv{block}_{conv}",
                    Conv(cin, filters, 3, kernel_init=_unset))
            cin = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = at_least_f32(x).permute(0, 3, 1, 2)
        prev = 1
        for block, conv, _ in VGG19_CFG:
            if block != prev:
                x = F.max_pool2d(x, 2, 2)
                prev = block
            x = torch.relu(getattr(self, f"conv{block}_{conv}")(x))
        return x.permute(0, 2, 3, 1)


def default_weights_path() -> str:
    return os.environ.get("VGG19_WEIGHTS",
                          os.path.join("models", "vgg19_notop.npz"))


def seeded_vgg_params(seed: int = INIT_SEED) -> dict:
    """The fixed-seed Flax-layout tree: kernels N(0, 1 / fan_in) (LeCun
    normal, Flax's default conv init), biases zero."""
    rng = np.random.default_rng(seed)
    params, cin = {}, 3
    for block, conv, filters in VGG19_CFG:
        std = np.sqrt(1.0 / (9 * cin))
        params[f"conv{block}_{conv}"] = {
            "kernel": (rng.standard_normal((3, 3, cin, filters))
                       * std).astype(np.float32),
            "bias": np.zeros(filters, np.float32)}
        cin = filters
    return params


def init_vgg_params(weights_path: str | None = None,
                    device: torch.device | str = "cpu") -> VGG19Features:
    """A frozen VGG19Features on `device` (eval mode, no gradients), from
    the ``.npz`` at `weights_path` (default: default_weights_path()) or,
    without it, from seeded_vgg_params with a warning."""
    path = weights_path or default_weights_path()
    if os.path.exists(path):
        with np.load(path) as data:
            params = {f"conv{b}_{c}": {
                "kernel": data[f"conv{b}_{c}/kernel"],
                "bias": data[f"conv{b}_{c}/bias"]} for b, c, _ in VGG19_CFG}
    else:
        msg = (
            f"VGG19 weights not found at '{path}' — the perceptual/content "
            "loss will use FIXED-SEED RANDOM VGG features, not ImageNet "
            "features.  The reference hard-requires ImageNet weights; "
            "convert a Keras VGG19 notop .h5 with tools/convert_vgg19.py "
            "and set VGG19_WEIGHTS or place it at models/vgg19_notop.npz "
            "for feature parity.")
        warnings.warn(msg, stacklevel=2)
        print(f"WARNING: {msg}")
        params = seeded_vgg_params()
    model = from_jax_params(VGG19Features(), params).to(device).eval()
    return model.requires_grad_(False)


def content_features(vgg: VGG19Features, img_m11: torch.Tensor
                     ) -> torch.Tensor:
    """block5_conv4 features / 12.75 of a [-1, 1] NHWC image."""
    return vgg(preprocess(img_m11)) / FEATURE_SCALE
