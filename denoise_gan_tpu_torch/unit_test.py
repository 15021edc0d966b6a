"""Inference comparison run (the repository root's unit_test.py): the
generator of a ``.dgt`` export on the top-left ``--crop`` square of each
PNG of ``--image_dir``, written as ``*_sr.png``, and a classical denoise of
that output beside it, ``*_sr_denoise.png``.  Inputs go in as [0, 1], as
the reference's do; outputs come out as (out + 1) / 2.
"""

from __future__ import annotations

import glob
import os
from argparse import ArgumentParser

import numpy as np
import torch
import torch.nn.functional as F

from denoise_gan_tpu_torch.data.pipeline import decode_image
from denoise_gan_tpu_torch.infer.image import build_forward, save_image_bgr
from denoise_gan_tpu_torch.utils.config import get_path


def denoise_median(img01: np.ndarray, k: int = 3) -> np.ndarray:
    """cv2.medianBlur(k=3) of the truncated uint8 image, in PyTorch: the
    median of each 3x3 window per channel, the border replicated."""
    if k != 3:
        raise ValueError(f"only the 3x3 median is ported, got k={k}")
    arr = (np.clip(img01, 0, 1) * 255).astype(np.uint8)
    x = torch.from_numpy(arr).permute(2, 0, 1)[None].float()
    x = F.pad(x, (1, 1, 1, 1), mode="replicate")
    windows = F.unfold(x, 3)                       # (1, C*9, H*W)
    h, w, c = arr.shape
    med = windows.reshape(c, 9, h * w).median(dim=1).values
    out = med.reshape(c, h, w).permute(1, 2, 0).to(torch.uint8).numpy()
    return out.astype(np.float32) / 255.0


def denoise_nlmeans(img01: np.ndarray, strength: float = 10.0) -> np.ndarray:
    """cv2.fastNlMeansDenoisingColored, the reference's other classical
    filter; it needs cv2."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError("--denoiser nlmeans needs cv2, which is not "
                           "installed; use --denoiser median") from None
    arr = (np.clip(img01, 0, 1) * 255).astype(np.uint8)
    out = cv2.fastNlMeansDenoisingColored(arr, None, strength, strength, 7,
                                          21)
    return out.astype(np.float32) / 255.0


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--image_dir", default="test/images", type=str)
    parser.add_argument("--model", default="./models/autoencoder.dgt",
                        type=str)
    parser.add_argument("--crop", default=256, type=int)
    parser.add_argument("--denoiser", default="median",
                        choices=["median", "nlmeans"],
                        help="classical comparison filter")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device (cuda by default)")
    args = parser.parse_args(argv)
    denoise = denoise_median if args.denoiser == "median" \
        else denoise_nlmeans

    _, _, forward = build_forward(get_path(args.model), device=args.device)
    paths = sorted(glob.glob(os.path.join(get_path(args.image_dir),
                                          "*.png")))
    for path in paths:
        img = decode_image(path)[:args.crop, :args.crop, :]
        x = torch.from_numpy(np.ascontiguousarray(img)).to(args.device)
        out = forward(x[None])[0]
        sr = (out.float().cpu().numpy() + 1.0) / 2.0
        stem = os.path.splitext(path)[0]
        save_image_bgr(stem + "_sr.png", sr)
        save_image_bgr(stem + "_sr_denoise.png", denoise(sr))
        print(f"{path}: wrote {stem}_sr.png, {stem}_sr_denoise.png")


if __name__ == "__main__":
    main()
