"""Regular-grid tiling for whole-frame inference
(denoise_gan_tpu/infer/engine.py:85-130)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def extract_grid(frame: torch.Tensor, ny: int, nx: int, tile, stride
                 ) -> torch.Tensor:
    """(Hp, Wp, C) padded frame -> (ny*nx, ty, tx, C) tiles on a regular
    grid, tile (y, x) starting at (y*sy, x*sx).  `tile`/`stride` may be
    (row, col) pairs for rectangular tiles.  Tiles reaching past the frame
    read zeros there, as the JAX version does."""
    ty, tx = _pair(tile)
    sy, sx = _pair(stride)
    hp, wp, c = frame.shape
    need_h, need_w = (ny - 1) * sy + ty, (nx - 1) * sx + tx
    frame = frame[:need_h, :need_w]
    if hp < need_h or wp < need_w:
        frame = F.pad(frame, (0, 0, 0, max(0, need_w - wp),
                              0, max(0, need_h - hp)))
    tiles = frame.unfold(0, ty, sy).unfold(1, tx, sx)   # (ny, nx, C, ty, tx)
    return tiles.permute(0, 1, 3, 4, 2).reshape(ny * nx, ty, tx, c)


def crop_stitch(tiles: torch.Tensor, ny: int, nx: int, tile: int,
                stride: int) -> torch.Tensor:
    """(ny*nx, tile, tile, C) -> (ny*stride, nx*stride, C): each tile gives
    its central stride x stride cell ((tile-stride)/2 margins cropped)."""
    m0 = (tile - stride) // 2
    c = tiles.shape[-1]
    x = tiles.reshape(ny, nx, tile, tile, c)
    core = x[:, :, m0:m0 + stride, m0:m0 + stride, :]
    return core.permute(0, 2, 1, 3, 4).reshape(ny * stride, nx * stride, c)
