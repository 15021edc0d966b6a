"""The seeded images and hashes that the image-codec fixtures' sidecar
(tests/data/codec/codec.json) is keyed by: numpy and hashlib only, so that
tests/make_codec_fixtures.py, tests/test_torch_codec.py and chip_smoke.py's
phase 4l draw the same images on every machine."""

from __future__ import annotations

import hashlib

import numpy as np


def seeded_image(h: int, w: int, seed: int) -> np.ndarray:
    """An RGB uint8 (h, w, 3) image from numpy's float stream alone (a
    smooth pattern with noise), the same on every machine."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    phase = rng.random(3) * 6.0
    img = (0.5 + 0.4 * np.sin(xx[..., None] / 5.0 + yy[..., None] / 7.0
                              + phase) + 0.15 * (rng.random((h, w, 3)) - 0.5))
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def roundtrip_key(h: int, w: int, q: int) -> str:
    """The sidecar's key of the round trip of an (h, w) image at q."""
    return f"{h}x{w}_q{q}"


def digest(img: np.ndarray | None) -> str | None:
    """The sha256 of an image's bytes (None for None)."""
    if img is None:
        return None
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
