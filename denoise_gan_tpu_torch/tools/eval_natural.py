"""Natural-image quality eval (tools/eval_natural.py): a trained export
scored on overlapping 256^2 crops of real photographs (the package's
copies of sklearn's china and flower and matplotlib's grace_hopper,
assets/photos/, read by the port's codec), degraded by the exact libjpeg
round trip (data/native.py::jpeg_roundtrip_u8), against the degraded
input.

Per quality q: the crops on a stride-128 grid (8 + 8 + 9), downscaled by
the model's scale with TensorFlow's bicubic (ops/image.py::
resize_bicubic_tf, the reference's tf.image.resize), to uint8, through the
round trip at q, to [-1, 1], through the f32 generator (infer/image.py::
build_forward(fast=False)) in batches of 8; PSNR/SSIM of clip((y + 1) / 2)
against the clean crop, next to the degraded input's (its bicubic upscale
when the model upscales), and each photo's dPSNR.  The flags are the JAX
tool's, with ``--device`` (the card unless ``cpu`` is asked for) in place
of ``--platform``::

    python3 -m denoise_gan_tpu_torch.tools.eval_natural \\
        --model models/nat_autoencoder.dgt --photos hopper --qs 10,30,50
"""

from __future__ import annotations

import argparse
from typing import Callable

import numpy as np
import torch

from denoise_gan_tpu_torch.data import native
from denoise_gan_tpu_torch.infer.image import build_forward, upscales
from denoise_gan_tpu_torch.ops.image import resize_bicubic, resize_bicubic_tf
from denoise_gan_tpu_torch.ops.metrics import psnr, ssim
from denoise_gan_tpu_torch.tools.train_natural import ASSETS, load_rgb01
from denoise_gan_tpu_torch.utils.device import resolve_device

EVAL_CROP = 256
STRIDE = 128
BATCH = 8

PHOTO_PATHS = [
    ("china", ASSETS / "photos" / "china.jpg"),
    ("flower", ASSETS / "photos" / "flower.jpg"),
    ("hopper", ASSETS / "photos" / "grace_hopper.jpg"),
]


def load_photo_crops() -> list[tuple[str, np.ndarray]]:
    """(name, crop01) pairs: all 256^2 crops on a stride-128 grid."""
    out = []
    for name, path in PHOTO_PATHS:
        im = load_rgb01(path)
        h, w = im.shape[:2]
        for y in range(0, h - EVAL_CROP + 1, STRIDE):
            for x in range(0, w - EVAL_CROP + 1, STRIDE):
                out.append((name, im[y:y + EVAL_CROP, x:x + EVAL_CROP]))
    return out


@torch.inference_mode()
def score(forward: Callable[[torch.Tensor], torch.Tensor], lo_m11: np.ndarray,
          hr01: np.ndarray, scale: int, dev: torch.device
          ) -> list[np.ndarray]:
    """Each crop's model PSNR, model SSIM, input PSNR and input SSIM, in
    batches of 8."""
    parts = []
    for i in range(0, len(lo_m11), BATCH):
        lo = torch.from_numpy(lo_m11[i:i + BATCH]).to(dev)
        hi = torch.from_numpy(hr01[i:i + BATCH]).to(dev)
        out01 = torch.clamp((forward(lo) + 1.0) / 2.0, 0.0, 1.0)
        lo01 = (lo + 1.0) / 2.0
        if scale > 1:
            h = hi.shape[1]
            bar01 = torch.clamp(resize_bicubic(lo01, h, h), 0.0, 1.0)
        else:
            bar01 = lo01
        parts.append([v.float().cpu().numpy() for v in (
            psnr(out01, hi), ssim(out01, hi), psnr(bar01, hi),
            ssim(bar01, hi))])
    return [np.concatenate([p[k] for p in parts]) for k in range(4)]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", required=True)
    p.add_argument("--qs", default="10,30,50")
    p.add_argument("--photos", default="",
                   help="comma list restricting the eval sources (e.g. "
                        "'hopper' to score only the photo held out from "
                        "tools/train_natural.py's corpus)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the card, the default), 'cuda:N' or 'cpu'")
    return p


def main(argv=None) -> list[str]:
    args = build_parser().parse_args(argv)
    if not native.available():
        raise SystemExit(f"the image codec is unavailable: "
                         f"{native.build_error}")
    dev = resolve_device(args.device)
    config, _, forward = build_forward(args.model, fast=False, device=dev)
    scale = config["scale"] if upscales(config) else 1

    crops = load_photo_crops()
    if args.photos:
        keep = set(args.photos.split(","))
        crops = [(n, c) for n, c in crops if n in keep]
    if not crops:
        raise SystemExit(f"no photographs named {args.photos!r}")
    names = sorted({n for n, _ in crops})
    hr01 = np.stack([c for _, c in crops])
    srcs = np.array([names.index(n) for n, _ in crops])

    if scale > 1:
        s = EVAL_CROP // scale
        lo01 = resize_bicubic_tf(torch.from_numpy(hr01), s, s).numpy()
    else:
        lo01 = hr01
    lo_u8 = np.clip(np.round(lo01 * 255.0), 0, 255).astype(np.uint8)

    lines = [f"model: {args.model}  scale={scale}  "
             f"crops={len(crops)} from {len(names)} photos: {names}", "",
             "| q | model PSNR/SSIM | input PSNR/SSIM | dPSNR | dSSIM | "
             "per-photo dPSNR |", "|---|---|---|---|---|---|"]
    for line in lines:
        print(line)
    for q in [int(x) for x in args.qs.split(",")]:
        jl = np.stack([native.jpeg_roundtrip_u8(im, q) for im in lo_u8])
        lo_lib = (jl.astype(np.float32) / 255.0) * 2.0 - 1.0
        pm, sm, pi, si = score(forward, lo_lib, hr01, scale, dev)
        per = " ".join(
            f"{names[k]}:{(pm[srcs == k].mean() - pi[srcs == k].mean()):+.2f}"
            for k in range(len(names)))
        row = (f"| {q} | {pm.mean():.2f} / {sm.mean():.4f} "
               f"| {pi.mean():.2f} / {si.mean():.4f} "
               f"| **{pm.mean()-pi.mean():+.2f}** "
               f"| **{sm.mean()-si.mean():+.4f}** | {per} |")
        print(row, flush=True)
        lines.append(row)
    return lines


if __name__ == "__main__":
    main()
