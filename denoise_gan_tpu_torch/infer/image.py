"""Still-image inference CLI (denoise_gan_tpu/infer/image.py): each image
of a directory through the generator of a ``.dgt`` export, written out.

The flags and defaults are the JAX CLI's, plus ``--device`` (the card by
default).  As there, images go in as [0, 1] (``--input_range unit``, the
reference's quirk) or [-1, 1] (``tanh``), and come out as (out + 1) / 2.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser
from typing import Callable

import numpy as np
import torch

from denoise_gan_tpu_torch.data import native
from denoise_gan_tpu_torch.data.pipeline import decode_image
from denoise_gan_tpu_torch.infer.fast import build_fast_forward
from denoise_gan_tpu_torch.infer.tile import tiled_apply
from denoise_gan_tpu_torch.io.checkpoint import load_generator
from denoise_gan_tpu_torch.utils.config import get_path
from denoise_gan_tpu_torch.utils.device import no_tf32


def build_forward(model_path: str, fast: bool = True,
                  device: torch.device | str = "cuda"
                  ) -> tuple[dict, torch.nn.Module,
                             Callable[[torch.Tensor], torch.Tensor]]:
    """(config, generator, NHWC -> NHWC forward) of an export on `device`.
    fast=True is infer/fast.py's build_fast_forward (bf16; FSRGAN and SRGAN
    through the coarse tail, the 1x families through their plain module);
    fast=False the plain generator in f32, TF32 off."""
    config, model = load_generator(model_path, device=device)
    if fast:
        return config, model, build_fast_forward(model)

    @torch.inference_mode()
    def forward(x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            return model(x)

    return config, model, forward


def upscales(config: dict) -> bool:
    """Whether the export's family upscales (the JAX bundle's
    ``upscales``): SRGAN and FSRGAN do, the autoencoder and pix2pix not."""
    return config["family"] in ("srgan", "fsrgan")


def save_image_bgr(path: str, rgb01: np.ndarray) -> None:
    """clip(x * 255) as uint8 (truncated, as the JAX CLI): ``.npy`` as the
    RGB array; ``.png``, ``.jpg`` and ``.jpeg`` by the port's codec
    (data/native.py::encode: PNG lossless, JPEG the bytes cv2.imwrite
    writes at its defaults, quality 95 and 4:2:0); else by cv2 (BGR) or
    PIL, whichever is installed; without either a RuntimeError that names
    ``.npy``."""
    arr = np.clip(rgb01 * 255.0, 0, 255).astype(np.uint8)
    if path.endswith(".npy"):
        np.save(path, arr)
        return
    if path.lower().endswith((".png", *native.JPEG_SUFFIXES)):
        native.encode(path, arr)
        return
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        cv2.imwrite(path, arr[..., ::-1])
        return
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"cannot write {path}: no image encoder (cv2 or "
                           "PIL) is installed; write .npy instead") from None
    Image.fromarray(arr).save(path)


def run(args) -> list[str]:
    image_dir = get_path(args.image_dir)
    output_dir = get_path(args.output_dir)
    os.makedirs(output_dir, exist_ok=True)
    image_paths = [os.path.join(image_dir, x)
                   for x in sorted(os.listdir(image_dir))
                   if os.path.isfile(os.path.join(image_dir, x))]

    config, _, forward = build_forward(get_path(args.model),
                                       fast=bool(args.fast),
                                       device=args.device)
    scale = config["scale"] if upscales(config) else 1
    written = []
    for image_path in image_paths:
        low = decode_image(image_path)           # RGB [0, 1]
        x = low if args.input_range == "unit" else low * 2.0 - 1.0
        x = torch.from_numpy(np.ascontiguousarray(x)).to(args.device)
        if args.tile:
            out = tiled_apply(forward, x, args.tile, args.tile_overlap,
                              scale, batch=args.tile_batch)
        else:
            out = forward(x[None])[0]
        sr = (out.float().cpu().numpy() + 1.0) / 2.0
        dst = os.path.join(output_dir, os.path.basename(image_path))
        save_image_bgr(dst, sr)
        written.append(dst)
        print(f"  {image_path} -> {dst}  {low.shape} -> {sr.shape}")
    return written


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="denoise_gan_tpu_torch still-image "
                                        "inference")
    parser.add_argument("--image_dir", type=str,
                        help="Directory where images are kept.")
    parser.add_argument("--output_dir", type=str,
                        help="Directory where to output high res images.")
    parser.add_argument("--model", default="./models/autoencoder.dgt",
                        type=str,
                        help="Path to a .dgt export or a reference "
                             "Keras .h5 (read directly, family "
                             "auto-detected)")
    parser.add_argument("--input_range", default="unit",
                        choices=("unit", "tanh"),
                        help="unit=[0,1] input (reference quirk), "
                             "tanh=[-1,1]")
    parser.add_argument("--tile", default=0, type=int,
                        help="Tile size for overlap-tiled inference "
                             "(0=whole image)")
    parser.add_argument("--tile_overlap", default=32, type=int)
    parser.add_argument("--tile_batch", default=0, type=int)
    parser.add_argument("--fast", default=1, type=int,
                        help="coarse-space bf16 inference rewrite "
                             "(infer/fast.py)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device (cuda by default; cpu runs the "
                             "same code on the host)")
    return parser


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
