"""Image decoding for the inference CLIs (denoise_gan_tpu/data/pipeline.py:
58-79).

The JAX package prefers its native libjpeg/libpng codec
(denoise_gan_tpu/data/native.py), then cv2, then PIL.  The port reads
``.npy`` itself and otherwise uses cv2 or PIL where installed; the native
codec comes with training.  A JPEG may therefore decode one level apart
from the JAX package's native decode.
"""

from __future__ import annotations

import numpy as np


def decode_image(path: str) -> np.ndarray:
    """Decode to RGB float32 [0, 1] (HWC): ``.npy`` directly (uint8 / 255,
    the first three channels), else by cv2, else by PIL; without either a
    RuntimeError that names ``.npy``."""
    if path.endswith(".npy"):
        img = np.load(path)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        return np.ascontiguousarray(img[..., :3].astype(np.float32))
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is None:
            raise IOError(f"cannot decode {path}")
        return bgr[..., ::-1].astype(np.float32) / 255.0
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"cannot decode {path}: no image decoder (cv2 or "
                           "PIL) is installed; give the image as .npy "
                           "(HWC, uint8 or float in [0, 1])") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0
