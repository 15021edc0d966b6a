"""Quality evaluation (tools/evaluate.py): mean PSNR/SSIM of a generator
export over a directory of images, beside the degraded input's.

Each HR crop is degraded as training degrades it (data/degrade.py: bicubic
downscale by the model's scale, then JPEG at ``--jpeg_quality``), run
through the generator, and ``clip((y + 1) / 2)`` is scored against the
clean crop; the bar is the degraded input itself at 1x and its bicubic
upscale (clipped) when the model upscales.  The flags and defaults are the
JAX tool's, plus ``--device`` (the card unless ``cpu`` is asked for)::

    python3 -m denoise_gan_tpu_torch.tools.evaluate --image_dir data/val \\
        --model models/fsrgan_4x_50q.dgt
"""

from __future__ import annotations

import argparse
from typing import Callable

import numpy as np
import torch

from denoise_gan_tpu_torch.data.degrade import degrade_pair
from denoise_gan_tpu_torch.data.pipeline import DataPipeline
from denoise_gan_tpu_torch.infer.image import build_forward, upscales
from denoise_gan_tpu_torch.ops.image import resize_bicubic
from denoise_gan_tpu_torch.ops.metrics import psnr, ssim
from denoise_gan_tpu_torch.utils.config import get_path, make_config
from denoise_gan_tpu_torch.utils.device import resolve_device


@torch.inference_mode()
def score_batch(forward: Callable[[torch.Tensor], torch.Tensor],
                hr01: torch.Tensor, scale: int, jpeg_quality: int
                ) -> tuple[torch.Tensor, ...]:
    """Per image: (model PSNR, model SSIM, input PSNR, input SSIM) of an
    NHWC [0, 1] HR batch (tools/evaluate.py's eval_batch)."""
    lo, hi = degrade_pair(hr01, scale, jpeg_quality)
    out01 = torch.clamp((forward(lo) + 1.0) / 2.0, 0.0, 1.0)
    clean01 = (hi + 1.0) / 2.0
    if scale > 1:
        h, w = hr01.shape[1:3]
        bar01 = torch.clamp(resize_bicubic((lo + 1.0) / 2.0, h, w), 0.0, 1.0)
    else:
        bar01 = (lo + 1.0) / 2.0
    return (psnr(out01, clean01), ssim(out01, clean01),
            psnr(bar01, clean01), ssim(bar01, clean01))


def score_pipeline(forward, pipe: DataPipeline, scale: int,
                   jpeg_quality: int, device: torch.device,
                   max_batches: int = 0) -> tuple[np.ndarray, ...]:
    """score_batch over an epoch of `pipe` (its first `max_batches`
    batches, when not 0): the four per-image arrays."""
    stats = []
    for i, hr in enumerate(pipe.epoch()):
        if max_batches and i >= max_batches:
            break
        hr01 = torch.from_numpy(hr).to(device)
        stats.append([x.float().cpu().numpy()
                      for x in score_batch(forward, hr01, scale,
                                           jpeg_quality)])
    return tuple(np.concatenate([s[k] for s in stats]) for k in range(4))


def evaluate(model_path: str, image_dir: str, crop_size: int = 256,
             jpeg_quality: int = 50, batch_size: int = 8,
             max_batches: int = 0, fast: bool = True,
             device: torch.device | str = "cuda"
             ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(model PSNR, model SSIM, input PSNR, input SSIM), one value per
    image, of the export at `model_path` over `image_dir` (its crops as
    the training pipeline takes them, seed 0).  fast=True is the bf16
    forward of infer/fast.py, fast=False the f32 generator."""
    return _evaluate(model_path, image_dir, crop_size, jpeg_quality,
                     batch_size, max_batches, fast, device)[1]


def _evaluate(model_path, image_dir, crop_size, jpeg_quality, batch_size,
              max_batches, fast, device):
    """(the scale scored at, evaluate's four arrays)."""
    dev = resolve_device(device)
    config, _, forward = build_forward(get_path(model_path), fast=fast,
                                       device=dev)
    scale = config["scale"] if upscales(config) else 1
    cfg = make_config("autoencoder", image_dir=get_path(image_dir))
    cfg.crop_size = crop_size
    cfg.batch_size = batch_size
    cfg.scale = scale
    cfg.jpeg_quality = jpeg_quality
    cfg.finalize()
    pipe = DataPipeline(cfg)
    try:
        return scale, score_pipeline(forward, pipe, scale, cfg.jpeg_quality,
                                     dev, max_batches)
    finally:
        pipe.close()


def report(po, so, pb, sb, scale: int, jpeg_quality: int) -> list[str]:
    """The JAX tool's four lines."""
    return [
        f"images: {len(po)}  (scale={scale}, q={jpeg_quality})",
        f"model  PSNR {po.mean():6.2f} dB   SSIM {so.mean():.4f}",
        f"input  PSNR {pb.mean():6.2f} dB   SSIM {sb.mean():.4f}  "
        "(degraded baseline)",
        f"delta  PSNR {po.mean()-pb.mean():+6.2f} dB   SSIM "
        f"{so.mean()-sb.mean():+.4f}"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image_dir", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--crop_size", type=int, default=256)
    p.add_argument("--jpeg_quality", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--fast", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the card, the default), 'cuda:N' or 'cpu'")
    return p


def main(argv=None) -> list[str]:
    args = build_parser().parse_args(argv)
    scale, arrays = _evaluate(args.model, args.image_dir, args.crop_size,
                              args.jpeg_quality, args.batch_size,
                              args.max_batches, bool(args.fast), args.device)
    lines = report(*arrays, scale, int(args.jpeg_quality))
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    main()
