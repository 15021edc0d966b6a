"""Weights carried across from the JAX package.

``from_jax_params`` fills a port module from Flax's nested ``params`` and
``batch_stats`` dicts (the trees ``denoise_gan_tpu/io/checkpoint.py``
exports), with numpy-convertible leaves.  The port's module names mirror the
Flax scopes, so ``body/InvertedResidual_1/expand/kernel`` becomes
``body.InvertedResidual_1.expand.weight``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def _leaves(tree: Mapping, prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def jax_state_dict(params: Mapping,
                   batch_stats: Mapping | None = None) -> dict[str, torch.Tensor]:
    """Flax trees -> a torch state dict, all f32.  Conv kernels go HWIO ->
    OIHW, so a depthwise (3, 3, 1, C) kernel becomes (C, 1, 3, 3); BN
    scale/bias/mean/var and PReLU alphas keep their shape."""
    out = {}
    for tree in (params, batch_stats or {}):
        for path, leaf in _leaves(tree):
            arr = np.asarray(leaf, np.float32)
            name = path[-1]
            if name == "kernel":
                arr, name = arr.transpose(3, 2, 0, 1), "weight"
            out[".".join(path[:-1] + (name,))] = torch.tensor(arr)
    return out


def from_jax_params(model: nn.Module, params: Mapping,
                    batch_stats: Mapping | None = None) -> nn.Module:
    """Fill `model` in place from Flax trees and return it.  Raises KeyError
    when a tensor of the model has no Flax leaf or a Flax leaf is not used,
    and ValueError on a shape mismatch."""
    state = jax_state_dict(params, batch_stats)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unused = sorted(set(state) - set(own))
    if missing or unused:
        raise KeyError(f"Flax tree does not match the model: missing "
                       f"{missing}, unused {unused}")
    for name, value in state.items():
        if value.shape != own[name].shape:
            raise ValueError(f"{name}: Flax shape {tuple(value.shape)} != "
                             f"model shape {tuple(own[name].shape)}")
    model.load_state_dict(state)
    return model
