"""The generic frame engine (denoise_gan_tpu/infer/engine.py:38-253):
normalise -> edge-pad -> extract_grid -> forward -> stitch -> one
depth_to_space, for any generator forward.

Scale > 1 forwards stop before their last depth_to_space (infer/fast.py's
coarse tail): tiles are stitched on the coarse (H, W, 3*s*s) phase-channel
canvas, and the fine frame comes from one depth_to_space at the end.  The
feather weights are per phase channel, so this equals feathering in fine
space exactly.  The frame is edge-padded so that tiles form an exact
(ny, nx) grid at stride = tile - overlap; overlap < stride puts each
output pixel in at most two tiles per axis, so the feathered overlap-add
is two shifted adds per axis (``overlap_add``), rows first, then columns,
in the JAX engine's order.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from denoise_gan_tpu_torch.infer.tile import _feather
from denoise_gan_tpu_torch.ops.image import depth_to_space
from denoise_gan_tpu_torch.parallel.mesh import (
    Mesh, data_only, gather_rows, row_range,
)
from denoise_gan_tpu_torch.utils.device import no_tf32, resolve_device


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _phase_feather(tile: int, scale: int, overlap: int, c: int
                   ) -> np.ndarray:
    """(tile, tile, c*scale^2) feather weights: the fine-space feather
    rearranged into phase channels (channel (e*scale+f)*c + o receives
    w_fine(scale*i+e, scale*j+f))."""
    fine = _feather(tile, scale, overlap)                 # (tile*s, tile*s)
    t, s = tile, scale
    w = fine.reshape(t, s, t, s).transpose(0, 2, 1, 3).reshape(t, t, s * s)
    return np.repeat(w, c, axis=-1)                       # c fastest


def _grid(size: int, tile: int, stride: int) -> int:
    """Number of grid cells covering `size` (after padding)."""
    if size <= tile:
        return 1
    return math.ceil((size - tile) / stride) + 1


def overlap_add(tiles: torch.Tensor, ny: int, nx: int, tile: int,
                stride: int) -> torch.Tensor:
    """(ny*nx, t, t, C) weighted tiles on a regular stride grid ->
    (ny*stride+ov, nx*stride+ov, C) canvas, ov = t - stride: each tile's
    head plus the previous tile's tail, along rows, then along columns."""
    t, ov = tile, tile - stride
    c = tiles.shape[-1]
    x = tiles.reshape(ny, nx, t, t, c)

    # rows: head [0:stride] + previous tile's tail [stride:] shifted one cell
    head, tail = x[:, :, :stride], x[:, :, stride:]      # tail (ny, nx, ov, t, c)
    tail_shift = F.pad(tail, (0, 0, 0, 0, 0, stride - ov, 0, 0, 1, 0))[:ny]
    rows = (head + tail_shift).permute(0, 2, 1, 3, 4).reshape(
        ny * stride, nx, t, c)
    rows = torch.cat([rows, tail[-1].permute(1, 0, 2, 3)])   # (H', nx, t, c)

    # cols: the same along the tile-x axis
    head, tail = rows[:, :, :stride], rows[:, :, stride:]    # (H', nx, ov, c)
    tail_shift = F.pad(tail, (0, 0, 0, stride - ov, 1, 0))[:, :nx]
    cols = (head + tail_shift).reshape(rows.shape[0], nx * stride, c)
    return torch.cat([cols, tail[:, -1]], dim=1)            # (H', W', c)


def crop_stitch(tiles: torch.Tensor, ny: int, nx: int, tile: int,
                stride: int) -> torch.Tensor:
    """(ny*nx, tile, tile, C) -> (ny*stride, nx*stride, C): each tile gives
    its central stride x stride cell ((tile-stride)/2 margins cropped)."""
    m0 = (tile - stride) // 2
    c = tiles.shape[-1]
    x = tiles.reshape(ny, nx, tile, tile, c)
    core = x[:, :, m0:m0 + stride, m0:m0 + stride, :]
    return core.permute(0, 2, 1, 3, 4).reshape(ny * stride, nx * stride, c)


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


def to_uint8(x01: torch.Tensor) -> torch.Tensor:
    """trunc(x * 255 + 0.5) as uint8, in x's dtype.  XLA's float -> uint8
    conversion saturates, and in bf16 x = 1 gives 255.5, which rounds to
    256: it becomes 255 there, so it is clamped here (torch's conversion
    wraps)."""
    return (x01 * 255.0 + 0.5).clamp(max=255.0).to(torch.uint8)


def build_frame_engine(forward_coarse: Callable[[torch.Tensor],
                                                torch.Tensor],
                       height: int, width: int, scale: int,
                       tile: int = 256, overlap: int = 16,
                       channels: int = 3, frames_per_call: int = 1,
                       out_uint8: bool = False,
                       acc_dtype: torch.dtype = torch.float32,
                       stitch: str = "feather", bgr: bool = False,
                       device: torch.device | str = "cuda",
                       mesh: Mesh | None = None):
    """fn(frame (H, W, 3) float in [0, 1] on `device`) -> the (H*scale,
    W*scale, 3) frame on it: uint8 with `out_uint8`, else `acc_dtype` in
    [0, 1].  The card unless the caller asks for the CPU (without a GPU a
    CUDA request raises RuntimeError); a frame on another device, or of
    another shape, raises ValueError.  The engine runs under
    torch.inference_mode with TF32 off (``no_tf32``), so f32 is f32.

    `forward_coarse`: (N, t, t, 3) [-1, 1] -> (N, t, t, channels*scale^2)
    phase-channel output in [-1, 1] (infer/fast.py's build_fast_coarse, or
    at scale 1 a generator).  Stitching: "feather" (the default; linear
    ramps across the overlaps, accumulated in `acc_dtype`, f32 or bf16) or
    "crop" (each tile gives its core; the frame is padded by overlap/2 on
    top and left).  ``tile`` <= 0 runs the whole frame in one forward, the
    frame edge-padded at the bottom and right to 8 rows and 128 columns
    (exact inference, no seams).  ``bgr`` emits BGR, at scale 1 only
    (ValueError otherwise).  ``frames_per_call`` > 1 returns fn over
    (F, H, W, 3) batches, run frame by frame inside the one call.

    ``mesh`` (parallel/mesh.py, the JAX engine's ``mesh``): the tile
    batch split over the ranks, each running `forward_coarse` on its
    share (``row_range``) on its own device (``device`` must be the
    rank's); the tiles gathered on every rank (``gather_rows``, exact),
    which stitches and returns the whole frame, as the JAX output is
    replicated.  The whole-frame mode is not split.  Not ported:
    ``flat_channels`` (a TPU lane layout of the u8 output; the port emits
    HWC)."""
    if bgr and scale != 1:
        raise ValueError("bgr=True supports scale==1 engines only (the "
                         "scale>1 phase-channel layout needs the kernel "
                         "engines' permutation instead)")
    if stitch not in ("feather", "crop"):
        raise ValueError(f"stitch must be 'feather' or 'crop', got "
                         f"{stitch!r}")
    data_only(mesh, "build_frame_engine")
    dev = resolve_device(device)
    whole = tile <= 0
    crop = stitch == "crop" and not whole
    m0 = (overlap // 2) if crop else 0
    if whole:
        # pad to 8 rows and 128 columns, as the JAX engine; no overlap
        ny = nx = 1
        pad_h = -(-height // 8) * 8
        pad_w = -(-width // 128) * 128
    else:
        stride = tile - overlap
        if crop:
            # top/left pre-pad of overlap/2 so that the tile cores land
            # exactly on real pixels (crop_stitch)
            ny, nx = -(-height // stride), -(-width // stride)
        else:
            ny, nx = _grid(height, tile, stride), _grid(width, tile, stride)
        pad_h = (ny - 1) * stride + tile
        pad_w = (nx - 1) * stride + tile
    cc = channels * scale * scale

    weight = inv_norm = None
    if not (whole or crop):
        weight = torch.from_numpy(_phase_feather(
            tile, scale, overlap, channels)).to(dev, acc_dtype)
        norm = overlap_add(weight.float().expand(ny * nx, tile, tile, cc),
                           ny, nx, tile, stride)
        inv_norm = (1.0 / norm.clamp(min=1e-8)).to(acc_dtype)
    rows = (torch.arange(pad_h, device=dev) - m0).clamp(0, height - 1)
    cols = (torch.arange(pad_w, device=dev) - m0).clamp(0, width - 1)
    split = mesh is not None and mesh.size > 1 and not whole
    if split and ny * nx < mesh.size:
        raise ValueError(f"{ny * nx} tiles do not split over {mesh.size} "
                         "ranks")

    def one_frame(frame01: torch.Tensor) -> torch.Tensor:
        x = (frame01 * 2.0 - 1.0).index_select(0, rows).index_select(1, cols)
        if whole:
            acc = forward_coarse(x[None])[0]             # (Hp, Wp, cc)
        else:
            tiles = extract_grid(x, ny, nx, tile, stride)
            if split:
                lo, hi = row_range(ny * nx, mesh)
                out = gather_rows(forward_coarse(tiles[lo:hi]), ny * nx,
                                  mesh)
            else:
                out = forward_coarse(tiles)
            if crop:
                acc = crop_stitch(out.to(acc_dtype), ny, nx, tile, stride)
            else:
                acc = overlap_add(out.to(acc_dtype) * weight, ny, nx, tile,
                                  stride) * inv_norm
        out01 = ((acc.to(acc_dtype) + 1.0) / 2.0).clamp(0.0, 1.0)
        if bgr:
            out01 = out01.flip(-1)
        if out_uint8:
            out01 = to_uint8(out01)
        if scale > 1:
            out01 = depth_to_space(out01[None], scale)[0]
        return out01[:height * scale, :width * scale]

    lead = () if frames_per_call == 1 else (frames_per_call,)

    @torch.inference_mode()
    def run(frames01: torch.Tensor) -> torch.Tensor:
        if frames01.shape != lead + (height, width, 3) or \
                not frames01.is_floating_point():
            raise ValueError(f"expected a float {lead + (height, width, 3)}"
                             f" input, got {frames01.dtype} "
                             f"{tuple(frames01.shape)}")
        if frames01.device != dev:
            raise ValueError(f"the frame is on {frames01.device}, the "
                             f"engine on {dev}")
        with no_tf32():
            if not lead:
                return one_frame(frames01)
            # frame by frame inside one call: the peak activation memory
            # stays one frame's
            return torch.stack([one_frame(f) for f in frames01])

    return run
