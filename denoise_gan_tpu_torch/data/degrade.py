"""The training pairs' degradation on the device (denoise_gan_tpu/data/
degrade.py): bicubic downscale by `scale` (ops/image.py::resize_bicubic,
JAX's cubic without antialias), clip to [0, 1], a JPEG round trip
(ops/jpeg.py), then both images mapped to [-1, 1].
"""

from __future__ import annotations

import torch

from denoise_gan_tpu_torch.ops.image import resize_bicubic
from denoise_gan_tpu_torch.ops.jpeg import jpeg_roundtrip, random_qualities
from denoise_gan_tpu_torch.parallel.mesh import Shard


def degrade_pair(hr01: torch.Tensor, scale: int, jpeg_quality,
                 generator: torch.Generator | None = None,
                 random_quality: bool = False, shard: Shard | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """An NHWC [0, 1] HR batch -> (degraded input, clean target), both in
    [-1, 1].  `jpeg_quality`: a number, or a tensor of one quality per
    image (the tests pin it so); with `random_quality` each image gets a
    quality drawn from [25, 75] by `generator` instead, and with `shard`
    (parallel/mesh.py) `hr01` is this rank's rows of a global batch whose
    qualities are drawn whole, this rank keeping its rows."""
    hr01 = hr01.float()
    n, h, w, _ = hr01.shape
    lr01 = hr01
    if scale > 1:
        lr01 = torch.clamp(resize_bicubic(hr01, h // scale, w // scale),
                           0.0, 1.0)
    if random_quality:
        count = 1 if shard is None else shard.count
        jpeg_quality = random_qualities(n * count, generator, hr01.device)
        if shard is not None:
            jpeg_quality = shard.take(jpeg_quality)
    lr01 = jpeg_roundtrip(lr01, jpeg_quality)
    return lr01 * 2.0 - 1.0, hr01 * 2.0 - 1.0
