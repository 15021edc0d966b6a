"""Paths as the CLIs take them (denoise_gan_tpu/utils/config.py:28-33)."""

from __future__ import annotations

import os


def get_path(*parts: str) -> str:
    """expanduser + expandvars + realpath of the joined parts, as the JAX
    package's get_path."""
    return os.path.realpath(
        os.path.expanduser(os.path.expandvars(os.path.join(*parts))))
