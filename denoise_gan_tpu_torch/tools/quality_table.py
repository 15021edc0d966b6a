"""Quality table (tools/quality_table.py): train every family a fixed
budget on a synthetic corpus, then score it on the held-out split beside
the degraded input.

The corpus is structured (a smooth background, filled rectangles and
circles, lines, mild texture), so the task is learnable; the degradation
is the training pipeline's (bicubic downscale by the scale, then JPEG at
the quality).  Its images are drawn with numpy alone, in the random stream
of the JAX tool's cv2 drawing: the same generator calls in the same order,
the background resized with cv2's INTER_CUBIC semantics and the shapes
rasterised as cv2 rasterises them (see ``synth_image``).  The flags are
the JAX tool's, plus ``--device`` (the card unless ``cpu`` is asked for)::

    python3 -m denoise_gan_tpu_torch.tools.quality_table \\
        [--families fsrgan,srgan,...] [--epochs N] [--smoke]

It writes the corpus under ``--data_root`` when that is missing, and the
exports under ``models/`` of the working directory.  The corpus and the
table's text need numpy alone; torch is imported by the training.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

# --------------------------------------------------------------------------
# The corpus

CUBIC_A = np.float32(-0.75)     # cv2's INTER_CUBIC kernel parameter
XY_SHIFT = 16                   # cv2's sub-pixel bits in its drawing code
XY_ONE = 1 << XY_SHIFT


def _cubic_taps(n_src: int, n_dst: int) -> tuple[np.ndarray, np.ndarray]:
    """cv2.resize's INTER_CUBIC taps along one axis: (n_dst, 4) source
    indices (clamped to the border) and f32 weights, from half-pixel
    centres, interpolateCubic's polynomial in f32."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    x = (f - s.astype(np.float32)).astype(np.float32)
    a, one = CUBIC_A, np.float32(1)
    x1 = x + one
    c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + one
    y = one - x
    c2 = ((a + 2) * y - (a + 3)) * y * y + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(s[:, None] + np.arange(-1, 3), 0, n_src - 1)
    return idx, np.stack([c0, c1, c2, c3], 1).astype(np.float32)


def resize_cubic(img: np.ndarray, size: int) -> np.ndarray:
    """cv2.resize(img, (size, size), interpolation=cv2.INTER_CUBIC) of an
    f32 HWC image: each row, then each column, four taps summed in f32
    in order."""
    h, w = img.shape[:2]
    ix, cx = _cubic_taps(w, size)
    iy, cy = _cubic_taps(h, size)
    rows = img[:, ix[:, 0]] * cx[None, :, 0, None]
    for k in range(1, 4):
        rows = rows + img[:, ix[:, k]] * cx[None, :, k, None]
    out = rows[iy[:, 0]] * cy[:, 0, None, None]
    for k in range(1, 4):
        out = out + rows[iy[:, k]] * cy[:, k, None, None]
    return out.astype(np.float32)


def _hline(img, y, x1, x2, color) -> None:
    img[y, x1:x2 + 1] = color


def _circle(img, cx: int, cy: int, radius: int, color) -> None:
    """cv2's filled Circle (drawing.cpp): the octant walk, each step's
    four spans clipped to the image."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            for y in (y11, y12):
                if 0 <= y < h:
                    _hline(img, y, x11, x12, color)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                for y in (y21, y22):
                    if 0 <= y < h:
                        _hline(img, y, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _line(img, p1, p2, color) -> None:
    """cv2's one-pixel Line: LineIterator, 8-connected, left to right."""
    (x1, y1), (x2, y2) = p1, p2
    if x2 < x1:
        (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
    dx, dy = x2 - x1, y2 - y1
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = color
        diag = err < 0
        err += minus + (plus if diag else 0)
        if vert:
            y += sy
            x += 1 if diag else 0
        else:
            x += 1
            y += sy if diag else 0


def _line2(img, p1, p2, color) -> None:
    """cv2's Line2: an 8-connected line between points of XY_SHIFT
    sub-pixel bits (a filled polygon's outline)."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    ax, ay = abs(x2 - x1), abs(y2 - y1)
    if ax > ay:
        if x2 < x1:
            (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
        step = _cdiv((y2 - y1) << XY_SHIFT, ax | 1)
        count = (x2 - x1) >> XY_SHIFT
    else:
        if y2 < y1:
            (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
        step = _cdiv((x2 - x1) << XY_SHIFT, ay | 1)
        count = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color

    put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        for _ in range(count + 1):
            put(x1, y1 >> XY_SHIFT)
            x1 += 1
            y1 += step
    else:
        y1 >>= XY_SHIFT
        for _ in range(count + 1):
            put(x1 >> XY_SHIFT, y1)
            x1 += step
            y1 += 1


def _clip_line(width: int, height: int, p1, p2):
    """cv2's clipLine: the segment cut to [0, width) x [0, height), or
    None when it lies outside."""
    right, bottom = width - 1, height - 1
    (x1, y1), (x2, y2) = p1, p2

    def code(x, y, ys=True):
        return ((x < 0) + (x > right) * 2
                + ((y < 0) * 4 + (y > bottom) * 8 if ys else 0))

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = code(x1, y1, False)
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = code(x2, y2, False)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return None if (c1 | c2) else ((x1, y1), (x2, y2))


def _cdiv(a: int, b: int) -> int:
    """C's integer division (towards zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _fill_convex(img, pts, color) -> None:
    """cv2's FillConvexPoly of points with XY_SHIFT sub-pixel bits: the
    outline by Line2, then one span a row between the two edges walked
    from the top vertex."""
    h, w = img.shape[:2]
    n = len(pts)
    delta = XY_ONE >> 1
    ys = [p[1] for p in pts]
    imin = int(np.argmin(ys))
    xmin, xmax = min(p[0] for p in pts), max(p[0] for p in pts)
    ymin, ymax = min(ys), max(ys)
    p0 = pts[-1]
    for p in pts:
        _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> XY_SHIFT, (xmax + delta) >> XY_SHIFT
    ymin, ymax = (ymin + delta) >> XY_SHIFT, (ymax + delta) >> XY_SHIFT
    if xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = n
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=n - 1, x=-XY_ONE, dx=0, ye=ymin)]
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0, di = e["idx"], e["di"]
                idx = (idx0 + di) % n
                while edges > 0:
                    edges -= 1
                    ty = (pts[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = pts[idx0][0], pts[idx][0]
                        e["ye"] = ty
                        e["dx"] = _cdiv((xe - xs) * 2 + (ty - y),
                                        2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % n
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = sorted(edge, key=lambda e: e["x"])
            x1 = (left["x"] + delta) >> XY_SHIFT
            x2 = (right["x"] + delta) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                _hline(img, y, max(x1, 0), min(x2, w - 1), color)
        for e in edge:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            break


def _thick_line(img, p1, p2, color, thickness: int) -> None:
    """cv2.line of `thickness` (LINE_8): one pixel wide by Line; wider, a
    filled quadrilateral about the segment and a filled disc at each
    end (ThickLine)."""
    if thickness <= 1:
        _line(img, p1, p2, color)
        return
    q1 = (p1[0] << XY_SHIFT, p1[1] << XY_SHIFT)
    q2 = (p2[0] << XY_SHIFT, p2[1] << XY_SHIFT)
    dx = (q1[0] - q2[0]) / XY_ONE
    dy = (q2[1] - q1[1]) / XY_ONE
    r2 = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(r2) > np.finfo(np.float64).eps:
        r = (t + odd * XY_ONE * 0.5) / np.sqrt(r2)
        ddx, ddy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex(img, [(q1[0] + ddx, q1[1] + ddy),
                           (q1[0] - ddx, q1[1] - ddy),
                           (q2[0] - ddx, q2[1] - ddy),
                           (q2[0] + ddx, q2[1] + ddy)], color)
    radius = (t + (XY_ONE >> 1)) >> XY_SHIFT
    for q in (q1, q2):
        _circle(img, (q[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                (q[1] + (XY_ONE >> 1)) >> XY_SHIFT, radius, color)


def synth_background(rng: np.random.Generator, size: int = 288
                     ) -> np.ndarray:
    """The low-frequency background: a 9x9 uniform image, resized."""
    base = rng.uniform(0, 1, (9, 9, 3)).astype(np.float32)
    return resize_cubic(base, size)


def synth_image(rng: np.random.Generator, size: int = 288) -> np.ndarray:
    """Structured synthetic image (tools/quality_table.py::synth_image):
    the background, 4-9 filled rectangles, filled circles or lines of
    width 1-5, then N(0, 0.02) texture, clipped to [0, 1]; f32 HWC."""
    img = synth_background(rng, size)
    for _ in range(rng.integers(4, 10)):
        color = rng.uniform(0, 1, 3).astype(float).astype(np.float32)
        kind = rng.integers(0, 3)
        if kind == 0:
            x0, y0 = (int(v) for v in rng.integers(0, size - 20, 2))
            w, h = (int(v) for v in rng.integers(10, size // 2, 2))
            img[y0:min(y0 + h, size - 1) + 1,
                x0:min(x0 + w, size - 1) + 1] = color
        elif kind == 1:
            c = rng.integers(20, size - 20, 2)
            _circle(img, int(c[0]), int(c[1]),
                    int(rng.integers(8, size // 4)), color)
        else:
            p1 = tuple(int(v) for v in rng.integers(0, size, 2))
            p2 = tuple(int(v) for v in rng.integers(0, size, 2))
            _thick_line(img, p1, p2, color, int(rng.integers(1, 6)))
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


def make_corpus(root: str, n_train: int = 240, n_val: int = 32) -> None:
    """``root/{train,val}/imgs/im%04d.npy`` (f32 HWC), one generator of
    seed 7 across both splits."""
    rng = np.random.default_rng(7)
    for split, n in [("train", n_train), ("val", n_val)]:
        d = os.path.join(root, split, "imgs")
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            np.save(os.path.join(d, f"im{i:04d}.npy"), synth_image(rng))
    print(f"corpus at {root}: {n_train} train / {n_val} val", flush=True)


# --------------------------------------------------------------------------
# The table

FAMILY_CFG = {
    # (crop, batch, scale, jpeg_quality, epochs)
    "autoencoder": (128, 8, 1, 10, 100),
    "pix2pix": (256, 4, 1, 10, 50),
    "srgan": (128, 8, 4, 50, 100),
    "fsrgan": (128, 8, 4, 50, 100),
}


def run_family(family: str, data_root: str, device="cuda",
               cfg_table: dict | None = None) -> dict:
    """Train `family` at its FAMILY_CFG budget on ``data_root/train``
    (models/<name>.dgt in the working directory), then score the export
    on ``data_root/val`` at f32 (tools/evaluate.py's scoring, batches of
    8).  Returns the JAX tool's RESULT dict, plus ms per step (the
    trainer's rate after its first step), peak device memory (MiB, on
    the card) and the export's path."""
    import torch

    from denoise_gan_tpu_torch.data.pipeline import DataPipeline, list_images
    from denoise_gan_tpu_torch.infer.image import build_forward
    from denoise_gan_tpu_torch.tools.evaluate import score_pipeline
    from denoise_gan_tpu_torch.train.loop import train
    from denoise_gan_tpu_torch.utils.config import make_config
    from denoise_gan_tpu_torch.utils.device import resolve_device

    crop, batch, scale, q, epochs = (cfg_table or FAMILY_CFG)[family]
    dev = resolve_device(device)
    cfg = make_config(family, image_dir=os.path.join(data_root, "train"))
    cfg.crop_size = crop
    cfg.batch_size = batch
    cfg.scale = scale
    cfg.jpeg_quality = q
    cfg.epochs = epochs
    cfg.retrain = 0
    cfg.ckpt = 0
    cfg.log_images = 0
    cfg.save_iter = 10 ** 9  # clamped to steps/epoch by train()
    cfg.device = str(dev)
    cfg.finalize()
    cfg.suffix_model_name()

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    state = train(cfg, family)
    train_s = time.time() - t0
    sps = state.timer.steps_per_sec
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 20 if on_card
            else None)

    export = os.path.join("models", f"{cfg.model_name}.dgt")
    _, _, forward = build_forward(export, fast=False, device=dev)
    vcfg = make_config("autoencoder", image_dir=os.path.join(data_root,
                                                             "val"))
    vcfg.crop_size = crop
    vcfg.batch_size = 8
    vcfg.finalize()
    pipe = DataPipeline(vcfg)
    try:
        po, so, pb, sb = score_pipeline(forward, pipe, scale, q, dev)
    finally:
        pipe.close()
    n_train = len(list_images(cfg.image_dir))
    res = dict(family=family, scale=scale, q=q,
               steps=epochs * (n_train // batch), train_s=round(train_s, 1),
               psnr_model=round(float(po.mean()), 2),
               ssim_model=round(float(so.mean()), 4),
               psnr_input=round(float(pb.mean()), 2),
               ssim_input=round(float(sb.mean()), 4),
               ms_step=round(1000.0 / sps, 2) if sps else None,
               peak_mib=round(peak, 1) if peak is not None else None,
               export=export)
    print("RESULT", res, flush=True)
    return res


def table(rows: list[dict]) -> list[str]:
    """The JAX tool's markdown table of RESULT rows."""
    lines = ["",
             "| Family | scale/q | steps | PSNR model | PSNR input | dPSNR |"
             " SSIM model | SSIM input | dSSIM |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['family']} | {r['scale']}x/q{r['q']} | {r['steps']} "
            f"| {r['psnr_model']} | {r['psnr_input']} "
            f"| **{r['psnr_model']-r['psnr_input']:+.2f}** "
            f"| {r['ssim_model']} | {r['ssim_input']} "
            f"| **{r['ssim_model']-r['ssim_input']:+.4f}** |")
    return lines


def budget(epochs: int = 0, smoke: bool = False) -> dict:
    """FAMILY_CFG with every family's epochs set to `epochs` (when not 0),
    or to 1 for `smoke`."""
    out = dict(FAMILY_CFG)
    for k, (c, b, s, q, e) in FAMILY_CFG.items():
        out[k] = (c, b, s, q, 1 if smoke else (epochs or e))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--families", default="autoencoder,pix2pix,srgan,fsrgan")
    p.add_argument("--data_root", default="qdata")
    p.add_argument("--epochs", type=int, default=0,
                   help="override the per-family epoch budget")
    p.add_argument("--smoke", action="store_true",
                   help="tiny corpus + 1 epoch (a shake-out)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the card, the default), 'cuda:N' or 'cpu'")
    return p


def main(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)
    cfg_table = budget(args.epochs, args.smoke)
    if not os.path.exists(args.data_root):
        make_corpus(args.data_root, n_train=16 if args.smoke else 240,
                    n_val=8 if args.smoke else 32)
    rows = [run_family(fam.strip(), args.data_root, args.device, cfg_table)
            for fam in args.families.split(",")]
    for line in table(rows):
        print(line)
    return rows


if __name__ == "__main__":
    main()
