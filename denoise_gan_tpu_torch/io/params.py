"""Weights carried across from the JAX package.

``from_jax_params`` fills a port module from Flax's nested ``params`` and
``batch_stats`` dicts (the trees ``denoise_gan_tpu/io/checkpoint.py``
exports), with numpy-convertible leaves or torch tensors (io/
flax_msgpack.py reads bf16 leaves as bf16 tensors); ``to_jax_trees`` is
its inverse.  The port's module names mirror the
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


def torch_kernel(path: tuple[str, ...], kernel: np.ndarray) -> np.ndarray:
    """The port's ``weight`` for the Flax ``kernel`` at `path`.  A conv's
    (kh, kw, in, out) kernel becomes OIHW (out, in, kh, kw), so a depthwise
    (3, 3, 1, C) kernel becomes (C, 1, 3, 3).  A ConvTranspose scope's
    kernel (Flax's transpose_kernel=False) becomes conv_transpose2d's (in,
    out, kh, kw), flipped in both spatial axes (models/layers.py::
    ConvTranspose says why)."""
    if len(path) > 1 and path[-2].startswith("ConvTranspose"):
        return np.ascontiguousarray(kernel[::-1, ::-1].transpose(2, 3, 0, 1))
    return kernel.transpose(3, 2, 0, 1)


def jax_state_dict(params: Mapping,
                   batch_stats: Mapping | None = None) -> dict[str, torch.Tensor]:
    """Flax trees -> a torch state dict, all f32.  Kernels become weights
    by ``torch_kernel``; BN scale/bias/mean/var and PReLU alphas keep their
    shape."""
    out = {}
    for tree in (params, batch_stats or {}):
        for path, leaf in _leaves(tree):
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.detach().float().cpu().numpy()
            arr = np.asarray(leaf, np.float32)
            name = path[-1]
            if name == "kernel":
                arr, name = torch_kernel(path, arr), "weight"
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


def to_jax_trees(model: nn.Module) -> tuple[dict, dict]:
    """The Flax (params, batch_stats) trees of `model`, f32 numpy leaves:
    the exact inverse of ``jax_state_dict``.  A ``weight`` becomes the
    HWIO ``kernel`` (a ConvTranspose scope's flipped back), BatchNorm
    ``mean``/``var`` go to batch_stats, every other tensor to params."""
    params, stats = {}, {}
    for name, t in model.state_dict().items():
        *path, leaf = name.split(".")
        arr = t.detach().float().cpu().numpy()
        if leaf == "weight":
            leaf = "kernel"
            if path[-1].startswith("ConvTranspose"):
                arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
            else:
                arr = arr.transpose(2, 3, 1, 0)
        tree = stats if leaf in ("mean", "var") else params
        for p in path:
            tree = tree.setdefault(p, {})
        tree[leaf] = np.ascontiguousarray(arr)
    return params, stats
