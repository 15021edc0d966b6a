"""Overlap-tiled inference for large frames (denoise_gan_tpu/infer/
tile.py:28-116).

A frame is cut into overlapping square tiles (the last one per axis flush
with the edge), the generator runs over the tile batch, and the tiles are
stitched with a linear feather in the overlaps, so no seams appear.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch


def plan_positions(size: int, tile: int, overlap: int) -> list[int]:
    """Tile start offsets covering [0, size) with `overlap` pixels shared
    between neighbours; the last tile is clamped flush to the edge."""
    if size <= tile:
        return [0]
    stride = tile - overlap
    n = math.ceil((size - tile) / stride) + 1
    return [min(i * stride, size - tile) for i in range(n)]


def plan_tiles(h: int, w: int, tile: int, overlap: int
               ) -> list[tuple[int, int]]:
    return [(y, x) for y in plan_positions(h, tile, overlap)
            for x in plan_positions(w, tile, overlap)]


def _feather(tile: int, scale: int, overlap: int) -> np.ndarray:
    """2-D blend weights at the output scale: flat centre, linear ramp
    across the overlap."""
    t = tile * scale
    o = max(overlap * scale, 1)
    ramp = np.minimum(np.arange(1, t + 1), o) / o
    w1 = np.minimum(ramp, ramp[::-1])
    return (w1[:, None] * w1[None, :]).astype(np.float32)


def _edge_pad(img: torch.Tensor, tile: int) -> torch.Tensor:
    """Edge-pad an HWC image at the bottom and right up to `tile` a side."""
    h, w = img.shape[:2]
    if h >= tile and w >= tile:
        return img
    rows = torch.arange(max(h, tile), device=img.device).clamp(max=h - 1)
    cols = torch.arange(max(w, tile), device=img.device).clamp(max=w - 1)
    return img.index_select(0, rows).index_select(1, cols)


def extract_tiles(img: torch.Tensor, tile: int, overlap: int
                  ) -> torch.Tensor:
    """HWC image -> (N, tile, tile, C) overlapping tile batch, in
    plan_tiles order.  An image smaller than `tile` is edge-padded up to
    it first."""
    img = _edge_pad(img, tile)
    h, w = img.shape[:2]
    return torch.stack([img[y:y + tile, x:x + tile]
                        for y, x in plan_tiles(h, w, tile, overlap)])


def stitch_tiles(tiles: torch.Tensor, h: int, w: int, tile: int,
                 overlap: int, scale: int = 1) -> torch.Tensor:
    """(N, tile*scale, tile*scale, C) -> (h*scale, w*scale, C) f32, the
    tiles feathered in the overlaps and added in plan_tiles order."""
    hh, ww = max(h, tile), max(w, tile)
    t = tile * scale
    c = tiles.shape[-1]
    weight = torch.from_numpy(_feather(tile, scale, overlap)).to(
        tiles.device)[..., None]
    acc = torch.zeros(hh * scale, ww * scale, c, device=tiles.device)
    norm = torch.zeros(hh * scale, ww * scale, 1, device=tiles.device)
    for i, (y, x) in enumerate(plan_tiles(hh, ww, tile, overlap)):
        ys, xs = y * scale, x * scale
        acc[ys:ys + t, xs:xs + t] += tiles[i].float() * weight
        norm[ys:ys + t, xs:xs + t] += weight
    out = acc / norm.clamp(min=1e-8)
    return out[:h * scale, :w * scale]


def tiled_apply(fn: Callable[[torch.Tensor], torch.Tensor],
                img: torch.Tensor, tile: int, overlap: int, scale: int,
                batch: int = 0) -> torch.Tensor:
    """Run `fn` (NHWC -> NHWC at `scale`, e.g. a generator) over the tile
    batch and stitch.  ``batch`` > 0 runs the tiles in chunks of that many;
    the last chunk is filled up with the leading tiles, so `fn` always sees
    the same batch size, and their outputs are dropped."""
    h, w = img.shape[:2]
    tiles = extract_tiles(img, tile, overlap)
    n = tiles.shape[0]
    if batch and n > batch:
        pad = (-n) % batch
        if pad:
            tiles = torch.cat([tiles, tiles[:pad]])
        out = torch.cat([fn(tiles[i:i + batch])
                         for i in range(0, tiles.shape[0], batch)])[:n]
    else:
        out = fn(tiles)
    return stitch_tiles(out, h, w, tile, overlap, scale)
