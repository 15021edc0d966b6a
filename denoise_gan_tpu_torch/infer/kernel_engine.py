"""FSRGAN 4x frame engine around the fused tail kernel
(denoise_gan_tpu/infer/kernel_engine.py:29-39, 71-168, 182-248).

Per frame: normalise to bf16 [-1, 1] -> edge-pad (m0 = 2) -> extract_grid
into (core_rows + 4) x 124 tiles at stride (core_rows, 120) -> FSRGAN body
(plain PyTorch, bf16) -> fused tail (ops/tail.py) -> the (4H, 4W, 3) uint8
frame.  The geometry is the JAX engine's, so outputs compare tile for tile.
"""

from __future__ import annotations

from typing import Callable

import torch

from denoise_gan_tpu_torch.infer.engine import extract_grid
from denoise_gan_tpu_torch.models.fsrgan import FSRGANBody, FSRGANGenerator
from denoise_gan_tpu_torch.ops.tail import (
    CORE, T, TailWeights, fused_tail_u8, prepare_tail,
)

M0 = 2    # crop-stitch margin: the frame is padded by M0 on top and left


def plan_grid(height: int, width: int, brc: int = 45,
              max_tiles: int = 128) -> tuple[int, int, int]:
    """(ny, nx, core_rows): col stride fixed at CORE = 120; rows chosen so
    ny*nx <= max_tiles when possible and core_rows % brc == 0."""
    nx = -(-width // CORE)
    ny = max(1, max_tiles // nx)
    while True:
        core_rows = brc * (-(-height // (ny * brc)))
        if ny <= 1 or (ny - 1) * core_rows < height:
            return ny, nx, core_rows
        ny -= 1


def _tiles(frame01: torch.Tensor, ny: int, nx: int, cr: int) -> torch.Tensor:
    """(H, W, 3) [0, 1] -> (ny*nx, cr+4, T, 3) bf16 [-1, 1] tiles of the
    edge-padded frame."""
    height, width = frame01.shape[:2]
    pad_h, pad_w = (ny - 1) * cr + cr + 4, (nx - 1) * CORE + T
    dev = frame01.device
    rows = (torch.arange(pad_h, device=dev) - M0).clamp(0, height - 1)
    cols = (torch.arange(pad_w, device=dev) - M0).clamp(0, width - 1)
    x = (frame01 * 2.0 - 1.0).to(torch.bfloat16)
    x = x.index_select(0, rows).index_select(1, cols)
    return extract_grid(x, ny, nx, (cr + 4, T), (cr, CORE))


def build_kernel_engine(body: FSRGANBody, tail: TailWeights, height: int,
                        width: int, brc: int = 45, bgr: bool = False,
                        tail_fn: Callable = fused_tail_u8):
    """body: NHWC (N, TR, T, 3) [-1, 1] -> (N, TR, T, 32) bf16.  Returns
    fn(frame01 (H, W, 3) float in [0, 1], on the body's device) ->
    (4H, 4W, 3) uint8, RGB or (bgr) BGR.  `tail_fn` is the kernel wrapper,
    or its twin ``fused_tail_u8_reference``."""
    ny, nx, cr = plan_grid(height, width, brc)

    @torch.inference_mode()
    def run(frame01: torch.Tensor) -> torch.Tensor:
        if frame01.shape != (height, width, 3):
            raise ValueError(f"expected a ({height}, {width}, 3) frame, got "
                             f"{tuple(frame01.shape)}")
        h = body(_tiles(frame01, ny, nx, cr)).contiguous()
        return tail_fn(h, tail, ny, nx, height, width, bgr=bgr)

    return run


def build_fsrgan_kernel_engine(model: FSRGANGenerator, height: int,
                               width: int, brc: int | None = None,
                               q8_calib_frame: torch.Tensor | None = None,
                               bgr: bool = False):
    """Wire the FSRGAN body (bf16, whatever the model's compute dtype, as
    in the JAX engine) to the fused tail, on the model's device.

    q8_calib_frame: an (H, W, 3) [0, 1] frame, or a list of them; the body
    runs on its leading tiles and the w8a8 tail is calibrated on the
    result.  None runs the bf16 tail.  brc=None picks 27 for w8a8 and 45
    for bf16, as the JAX engine does; it only sets core_rows here."""
    body, tail, brc = prepare_fsrgan_engine(model, height, width, brc,
                                            q8_calib_frame)
    return build_kernel_engine(body, tail, height, width, brc=brc, bgr=bgr)


def prepare_fsrgan_engine(model: FSRGANGenerator, height: int, width: int,
                          brc: int | None = None,
                          q8_calib_frame: torch.Tensor | None = None
                          ) -> tuple[FSRGANBody, TailWeights, int]:
    """The (bf16 body, tail weights, brc) that build_fsrgan_kernel_engine
    wires together; two engines built from one set share calibration."""
    if brc is None:
        brc = 27 if q8_calib_frame is not None else 45
    dev = model.tail.out_conv.weight.device
    body = FSRGANBody(model.body.gf, model.body.n_residual_blocks,
                      dtype=torch.bfloat16)
    body.load_state_dict(model.body.state_dict())
    body = body.to(dev).eval()
    sample = None
    if q8_calib_frame is not None:
        sample = _body_sample(body, q8_calib_frame, height, width, brc)
    return body, prepare_tail(model.tail, q8_calib=sample), brc


@torch.inference_mode()
def _body_sample(body: FSRGANBody, frames01, height: int, width: int,
                 brc: int, max_tiles: int = 16) -> torch.Tensor:
    """Body output on the leading tiles of sample frames: the calibration
    input of the w8a8 tail.  Tiles are split evenly across the frames, up to
    `max_tiles` in all."""
    if not isinstance(frames01, (list, tuple)):
        frames01 = [frames01]
    ny, nx, cr = plan_grid(height, width, brc)
    per = max(1, max_tiles // len(frames01))
    return torch.cat([body(_tiles(f, ny, nx, cr)[:per]) for f in frames01])
