"""Cross-oracle quality eval (tools/cross_oracle_eval.py): a trained
export scored on held-out images degraded by the exact libjpeg round trip
(the port's codec, data/native.py::jpeg_roundtrip_u8), beside the same
inputs degraded by the DCT approximation the models train with
(ops/jpeg.py::jpeg_roundtrip), at the training quality and others: does
the DCT noise model carry over to real JPEG artifacts?

Per quality q: the centre 256-crop of each val image, downscaled by the
model's scale with TensorFlow's bicubic (ops/image.py::resize_bicubic_tf,
the reference's tf.image.resize), to uint8, through the round trip at q,
to [-1, 1], through the f32 generator in batches of 8; PSNR/SSIM of
clip((y + 1) / 2) against the clean crop, next to the degraded input's
(its bicubic upscale when the model upscales).  The flags are the JAX
tool's, plus ``--device`` (the card unless ``cpu`` is asked for); where
``--data_root`` does not exist, tools/quality_table.py::make_corpus writes
the synthetic corpus there::

    python3 -m denoise_gan_tpu_torch.tools.cross_oracle_eval \\
        --model models/fsrgan_4x_50q.dgt --qs 30,50,70
"""

from __future__ import annotations

import argparse
import os
from typing import Callable

import numpy as np
import torch

from denoise_gan_tpu_torch.data import native
from denoise_gan_tpu_torch.infer.image import build_forward, upscales
from denoise_gan_tpu_torch.ops.image import resize_bicubic, resize_bicubic_tf
from denoise_gan_tpu_torch.ops.jpeg import jpeg_roundtrip
from denoise_gan_tpu_torch.ops.metrics import psnr, ssim
from denoise_gan_tpu_torch.tools.quality_table import make_corpus
from denoise_gan_tpu_torch.utils.config import get_path
from denoise_gan_tpu_torch.utils.device import resolve_device

EVAL_CROP = 256
BATCH = 8
HEADER = ["| oracle | q | model PSNR/SSIM | input PSNR/SSIM | dPSNR | dSSIM |",
          "|---|---|---|---|---|---|"]


def load_split(root: str, split: str) -> np.ndarray:
    """root/<split>/imgs/*.npy stacked in name order (f32 NHWC)."""
    d = os.path.join(root, split, "imgs")
    return np.stack([np.load(os.path.join(d, f))
                     for f in sorted(os.listdir(d))])


@torch.inference_mode()
def score(forward: Callable[[torch.Tensor], torch.Tensor], lo_m11: np.ndarray,
          hr01: np.ndarray, scale: int, dev: torch.device) -> list[float]:
    """Mean (model PSNR, model SSIM, input PSNR, input SSIM) over the
    images, in batches of 8."""
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
    return [float(np.concatenate([p[k] for p in parts]).mean())
            for k in range(4)]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", required=True)
    p.add_argument("--data_root", default="qdata",
                   help="the corpus (root/val/imgs/*.npy); written by "
                        "tools/quality_table.py::make_corpus when missing")
    p.add_argument("--qs", default="30,50,70")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the card, the default), 'cuda:N' or 'cpu'")
    return p


def main(argv=None) -> list[str]:
    args = build_parser().parse_args(argv)
    if not native.available():
        raise SystemExit(f"the image codec is unavailable: "
                         f"{native.build_error}")
    dev = resolve_device(args.device)
    config, _, forward = build_forward(get_path(args.model), fast=False,
                                       device=dev)
    scale = config["scale"] if upscales(config) else 1

    root = get_path(args.data_root)
    if not os.path.exists(root):
        make_corpus(root)
    val = load_split(root, "val")
    off = (val.shape[1] - EVAL_CROP) // 2
    hr01 = np.ascontiguousarray(
        val[:, off:off + EVAL_CROP, off:off + EVAL_CROP, :])
    if scale > 1:
        s = EVAL_CROP // scale
        lo01 = resize_bicubic_tf(torch.from_numpy(hr01), s, s).numpy()
    else:
        lo01 = hr01
    lo_u8 = np.clip(np.round(lo01 * 255.0), 0, 255).astype(np.uint8)

    lines = [f"model: {args.model}  scale={scale}  "
             f"(train oracle: on-device DCT approx)", "", *HEADER]
    for line in lines:
        print(line)
    for q in [int(x) for x in args.qs.split(",")]:
        jl = np.stack([native.jpeg_roundtrip_u8(im, q) for im in lo_u8])
        lo_lib = (jl.astype(np.float32) / 255.0) * 2.0 - 1.0
        pm, sm, pi, si = score(forward, lo_lib, hr01, scale, dev)
        rows = [f"| libjpeg | {q} | {pm:.2f} / {sm:.4f} | {pi:.2f} / "
                f"{si:.4f} | **{pm-pi:+.2f}** | **{sm-si:+.4f}** |"]
        with torch.inference_mode():
            lo_dct = (jpeg_roundtrip(torch.from_numpy(lo01).to(dev), q)
                      * 2.0 - 1.0).cpu().numpy()
        pm, sm, pi, si = score(forward, lo_dct, hr01, scale, dev)
        rows.append(f"| dct-dev | {q} | {pm:.2f} / {sm:.4f} | {pi:.2f} / "
                    f"{si:.4f} | {pm-pi:+.2f} | {sm-si:+.4f} |")
        for line in rows:
            print(line, flush=True)
        lines += rows
    return lines


if __name__ == "__main__":
    main()
