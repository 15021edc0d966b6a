"""Checkpoints and exports (denoise_gan_tpu/io/checkpoint.py), without
flax or Orbax.

Exports (``.dgt``, the JAX package's format): the magic ``DGTPU1\\n``,
the header's length as 8 little-endian bytes, a JSON header (family,
scale, format, role), then flax's msgpack of ``{"params": ...,
"batch_stats": ...}`` (io/flax_msgpack.py).  Generators and, for warm
starts, discriminators (``role``) both ways.

Training checkpoints are the port's own: ``torch.save`` of the whole train
state (train/state.py::GANTrainState.state_dict) as
``<dir>/step_<N>.pt``, the newest ``max_to_keep`` kept.  The JAX
package's Orbax directories are not read.

The reference's Keras ``.h5`` files are read as the JAX package reads
them, on the fly: ``load_generator`` and ``read_export`` send an HDF5 file
to io/keras_h5.py, which reads it without h5py (io/hdf5.py).
"""

from __future__ import annotations

import json
import os
import re

import torch

from denoise_gan_tpu_torch.io import flax_msgpack, keras_h5
from denoise_gan_tpu_torch.io.params import from_jax_params, to_jax_trees
from denoise_gan_tpu_torch.models import build_generator

EXPORT_MAGIC = b"DGTPU1\n"


def read_export(path: str) -> tuple[dict, bytes]:
    """(config dict, raw msgpack payload).  A reference Keras ``.h5`` is
    converted (io/keras_h5.py::load_h5: its family and role identified
    from the weight stream) and its trees encoded as an export's payload.
    Anything else that is not an export raises ValueError."""
    if keras_h5.is_hdf5(path):
        config, net = keras_h5.load_h5(path)
        params, stats = to_jax_trees(net)
        return config, flax_msgpack.dumps({"params": params,
                                           "batch_stats": stats})
    with open(path, "rb") as f:
        magic = f.read(len(EXPORT_MAGIC))
        if magic != EXPORT_MAGIC:
            raise ValueError(f"{path} is not a denoise_gan_tpu export")
        hlen = int.from_bytes(f.read(8), "little")
        config = json.loads(f.read(hlen))
        payload = f.read()
    return config, payload


def load_generator(path: str, device: torch.device | str = "cuda",
                   dtype: torch.dtype | None = None
                   ) -> tuple[dict, torch.nn.Module]:
    """(config, generator in eval mode on `device`, compute `dtype`) from a
    ``.dgt`` export or a reference Keras ``.h5`` (io/keras_h5.py::
    load_h5_generator).  The card unless the caller asks for the CPU:
    without a GPU a CUDA request raises RuntimeError.  A discriminator's
    file raises ValueError, as the JAX package's load_generator."""
    if keras_h5.is_hdf5(path):
        return keras_h5.load_h5_generator(path, device=device, dtype=dtype)
    config, payload = read_export(path)
    if config.get("role", "generator") != "generator":
        raise ValueError(f"{path} is a {config['role']} export, "
                         "not a generator")
    trees = flax_msgpack.loads(payload)
    model = build_generator(config["family"], dtype=dtype, device=device,
                            scale=config["scale"])
    return config, from_jax_params(model, trees["params"],
                                   trees.get("batch_stats", {}))


def export_net(path: str, family: str, scale: int, model: torch.nn.Module,
               role: str = "generator") -> None:
    """Write `model` as a ``.dgt`` export of `role` that the JAX package's
    read_export, load_generator (generators) and load_export_into read:
    the same header, and the Flax trees of ``to_jax_trees`` in flax's
    msgpack form."""
    params, stats = to_jax_trees(model)
    payload = flax_msgpack.dumps({"params": params, "batch_stats": stats})
    header = json.dumps({"family": family, "scale": scale, "format": 1,
                         "role": role}).encode()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(EXPORT_MAGIC)
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        f.write(payload)


def export_generator(path: str, family: str, scale: int,
                     model: torch.nn.Module) -> None:
    export_net(path, family, scale, model, "generator")


def load_export_into(path: str, model: torch.nn.Module) -> dict:
    """Fill `model` (a generator or a discriminator of the export's shape)
    in place from a ``.dgt`` export; returns its config.  A tree that does
    not match the model raises KeyError or ValueError (io/params.py)."""
    config, payload = read_export(path)
    trees = flax_msgpack.loads(payload)
    from_jax_params(model, trees["params"], trees.get("batch_stats", {}))
    return config


class CheckpointManager:
    """The train state's checkpoints under `ckpt_dir`: ``step_<N>.pt``,
    written by torch.save (to a temporary name, then renamed), the newest
    `max_to_keep` kept."""

    PATTERN = re.compile(r"step_(\d+)\.pt$")

    def __init__(self, ckpt_dir: str, max_to_keep: int = 3):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"step_{step}.pt")

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(
            self.PATTERN.match, os.listdir(self.ckpt_dir)) if m)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> None:
        tmp = self._path(step) + ".tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, state):
        """`state` filled from the newest checkpoint (unchanged where there
        is none), onto its own devices."""
        step = self.latest_step()
        if step is None:
            return state
        device = next(state.gen.model.parameters()).device
        state.load_state_dict(torch.load(self._path(step),
                                         map_location=device))
        return state
