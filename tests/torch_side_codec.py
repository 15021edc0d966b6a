"""The PyTorch half of tests/test_torch_codec.py and tests/
test_torch_cross_oracle.py: the port's image codec (data/native.py,
data/png.py, native/imgcodec.cpp), its users (data/pipeline.py, infer/
image.py::save_image_bgr), ops/image.py::resize_bicubic_tf and the
cross-oracle tool, on the CPU.

tests/torch_process.py runs these functions in a child process
(``torch_process("torch_side_codec")``), so that no pytest worker imports
torch.  They take and return numpy arrays and plain Python values.
"""

from __future__ import annotations

import contextlib
import io

import numpy as np
import torch

from denoise_gan_tpu_torch.data import native
from denoise_gan_tpu_torch.data import pipeline
from denoise_gan_tpu_torch.infer.image import save_image_bgr
from denoise_gan_tpu_torch.ops.image import resize_bicubic_tf
from denoise_gan_tpu_torch.tools import cross_oracle_eval


def decode_files(paths):
    """native.decode of each file (None where the codec refuses it)."""
    return [native.decode(p) for p in paths]


def roundtrips(images, qualities):
    """jpeg_roundtrip_u8 of each image at each quality: [image][quality]."""
    return [[native.jpeg_roundtrip_u8(img, q) for q in qualities]
            for img in images]


def encode_files(cases):
    """native.encode(path, rgb, quality) of each (path, rgb, quality)."""
    for path, rgb, quality in cases:
        native.encode(path, rgb, quality)


def save_images(cases):
    """infer/image.py::save_image_bgr of each (path, rgb01)."""
    for path, rgb01 in cases:
        save_image_bgr(path, rgb01)


def decode_images(paths):
    """(decoder name, data/pipeline.py::decode_image of each file)."""
    return pipeline.decoder(), [pipeline.decode_image(p) for p in paths]


def decode_image_results(paths):
    """data/pipeline.py::decode_image of each file: (None, the image), or
    (the message, None) where it raises an IOError."""
    out = []
    for p in paths:
        try:
            out.append((None, pipeline.decode_image(p)))
        except IOError as exc:
            out.append((str(exc), None))
    return out


def resize_tf(x, height, width):
    """ops/image.py::resize_bicubic_tf of an NHWC f32 array."""
    return resize_bicubic_tf(torch.from_numpy(x), height, width).numpy()


def cross_oracle(argv):
    """The cross-oracle tool's main with --device cpu: its printed
    lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cross_oracle_eval.main([*argv, "--device", "cpu"])
    return out.getvalue().splitlines()


def refused_calls(directory):
    """The ValueError message of each call the codec refuses: a
    round trip of a gray (H, W) array, a write of a 4-channel image, a
    write to another suffix."""
    calls = [lambda: native.jpeg_roundtrip_u8(np.zeros((4, 4), np.uint8), 75),
             lambda: native.encode(f"{directory}/a.jpg",
                                   np.zeros((4, 4, 4), np.uint8)),
             lambda: native.encode(f"{directory}/a.bmp",
                                   np.zeros((4, 4, 3), np.uint8))]
    out = []
    for call in calls:
        try:
            call()
        except ValueError as exc:
            out.append(str(exc))
        else:
            out.append(None)
    return out
