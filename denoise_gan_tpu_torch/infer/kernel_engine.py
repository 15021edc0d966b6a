"""4x frame engines around the fused tail kernels
(denoise_gan_tpu/infer/kernel_engine.py:29-39, 71-292).

Per frame: normalise to bf16 [-1, 1] -> edge-pad (m0 = 2) -> extract_grid
into (core_rows + 4) x 124 tiles at stride (core_rows, 120) -> body (bf16)
-> (qh8: ``quantize_h`` to int8) -> fused tail -> the (4H, 4W, 3) uint8
frame.  FSRGAN runs the CIN=32 tail (ops/tail.py), SRGAN the CIN=64 one
(ops/tail_srgan.py), each in bf16, w8a8 or qh8 mode (the tail weights
say which).  The FSRGAN body
is plain PyTorch (``prepare_fsrgan_engine``) or has its inverted residuals
as fused kernel launches (``prepare_mbconv_fsrgan_engine``, ops/mbconv.py).
The geometry is the JAX engine's, so outputs compare tile for tile.

Input options, as the JAX engines': ``u8_input`` takes the decoder's
(H, W, 3) uint8 frame and normalises per tile, after the pad and the
extraction; ``bgr_input`` takes BGR frames by flipping the stem conv's
input channels once, on the host.

Output, as the JAX engine's ``out_uint8``: with it (the default) the tail
kernel's u8 epilogue writes the (4H, 4W, 3) uint8 frame.  Without it the
kernel writes its bf16 canvas of tanh and the engine takes the JAX
engine's own steps (kernel_engine.py:157-166) to the (4H, 4W, 3) f32
frame clip((x + 1) / 2, 0, 1).  Both are HWC: the JAX package's 5D/flat
layout, and with it its ``flat_channels`` flag, is not ported.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from denoise_gan_tpu_torch.infer.engine import extract_grid
from denoise_gan_tpu_torch.models.fsrgan import FSRGANBody, FSRGANGenerator
from denoise_gan_tpu_torch.models.srgan import SRGANBody, SRGANGenerator
from denoise_gan_tpu_torch.ops.mbconv import (
    MBConvFSRGANBody, build_mbconv_fsrgan_body,
)
from denoise_gan_tpu_torch.ops.tail import (
    CORE, T, TailWeights, fused_tail_canvas, fused_tail_u8, prepare_tail,
    quantize_h,
)
from denoise_gan_tpu_torch.ops.tail_srgan import (
    fused_tail64_canvas, fused_tail64_u8, prepare_tail64,
)

M0 = 2    # crop-stitch margin: the frame is padded by M0 on top and left
# body channels -> the tail's (u8, canvas) wrappers
TAILS = {32: (fused_tail_u8, fused_tail_canvas),
         64: (fused_tail64_u8, fused_tail64_canvas)}


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


def _u8_levels(device: torch.device) -> torch.Tensor:
    """bf16 of ``u * (2/255) - 1`` for u = 0..255, with one f32 rounding:
    the jitted JAX engine fuses the multiply and the subtract into one
    fused multiply-add (kernel_engine.py:145-146), and two roundings differ
    from it at u = 127.  In f64 the product and the difference are exact."""
    u = torch.arange(256, dtype=torch.float64, device=device)
    step = float(np.float32(2.0 / 255.0))
    return (u * step - 1.0).float().to(torch.bfloat16)


def _tiles(frame: torch.Tensor, ny: int, nx: int, cr: int) -> torch.Tensor:
    """(H, W, 3) frame -> (ny*nx, cr+4, T, 3) bf16 [-1, 1] tiles of the
    edge-padded frame.  A float frame in [0, 1] is normalised first; a uint8
    frame is padded and tiled as bytes and normalised per tile, as the JAX
    engine (kernel_engine.py:141-146), by table (_u8_levels)."""
    height, width = frame.shape[:2]
    pad_h, pad_w = (ny - 1) * cr + cr + 4, (nx - 1) * CORE + T
    dev = frame.device
    rows = (torch.arange(pad_h, device=dev) - M0).clamp(0, height - 1)
    cols = (torch.arange(pad_w, device=dev) - M0).clamp(0, width - 1)
    u8 = frame.dtype == torch.uint8
    x = frame if u8 else (frame * 2.0 - 1.0).to(torch.bfloat16)
    x = x.index_select(0, rows).index_select(1, cols)
    tiles = extract_grid(x, ny, nx, (cr + 4, T), (cr, CORE))
    if u8:
        tiles = _u8_levels(dev)[tiles.int()]
    return tiles


def build_kernel_engine(body: torch.nn.Module, tail: TailWeights,
                        height: int, width: int, brc: int = 45,
                        bgr: bool = False,
                        tail_fn: Callable | None = None,
                        u8_input: bool = False, out_uint8: bool = True):
    """body: NHWC (N, TR, T, 3) [-1, 1] -> (N, TR, T, C) bf16.  Returns
    fn(frame (H, W, 3) on the body's device) -> the (4H, 4W, 3) frame:
    uint8, RGB or (bgr) BGR, when out_uint8, through the tail's u8
    epilogue; else through its canvas epilogue, f32 in [0, 1], RGB only
    (bgr raises ValueError).  The frame is float in [0, 1], or (u8_input)
    uint8.  qh8 tail weights quantise the body output with
    ``quantize_h``.  `tail_fn` is the tail kernel's
    wrapper for that epilogue (by default ``TAILS[tail.cin]``) or its
    twin."""
    ny, nx, cr = plan_grid(height, width, brc)
    if bgr and not out_uint8:
        raise ValueError("bgr=True needs the u8 kernel epilogue "
                         "(out_uint8=True)")
    if tail_fn is None:
        tail_fn = TAILS[tail.cin][0 if out_uint8 else 1]

    @torch.inference_mode()
    def run(frame: torch.Tensor) -> torch.Tensor:
        if frame.shape != (height, width, 3):
            raise ValueError(f"expected a ({height}, {width}, 3) frame, got "
                             f"{tuple(frame.shape)}")
        if u8_input != (frame.dtype == torch.uint8):
            raise ValueError(f"expected a {'uint8' if u8_input else 'float'}"
                             f" frame, got {frame.dtype}")
        h = body(_tiles(frame, ny, nx, cr)).contiguous()
        if tail.qh8:
            h = quantize_h(h, tail)
        out = tail_fn(h, tail, ny, nx, height, width, bgr=bgr)
        if out_uint8:
            return out
        return ((out.float() + 1.0) / 2.0).clamp(0.0, 1.0)

    return run


def build_fsrgan_kernel_engine(model: FSRGANGenerator, height: int,
                               width: int, brc: int | None = None,
                               q8_calib_frame: torch.Tensor | None = None,
                               bgr: bool = False, u8_input: bool = False,
                               bgr_input: bool = False, qh8: bool = False,
                               out_uint8: bool = True):
    """Wire the FSRGAN body (bf16, whatever the model's compute dtype, as
    in the JAX engine) to the fused tail, on the model's device.

    q8_calib_frame: an (H, W, 3) [0, 1] RGB frame, or a list of them; the
    body runs on their leading tiles and the w8a8 tail is calibrated on the
    result, or with `qh8` the qh8 tail (h step sizes calibrated on the same
    tiles).  None runs the bf16 tail; qh8 without it raises ValueError.
    brc=None picks 27 for the int8 modes and 45 for bf16, as the JAX engine
    does; it only sets core_rows here.  bgr writes BGR bytes; u8_input and
    bgr_input set the input, out_uint8 the output (see the module
    docstring)."""
    body, tail, brc = prepare_fsrgan_engine(model, height, width, brc,
                                            q8_calib_frame, bgr_input, qh8)
    return build_kernel_engine(body, tail, height, width, brc=brc, bgr=bgr,
                               u8_input=u8_input, out_uint8=out_uint8)


def prepare_fsrgan_engine(model: FSRGANGenerator, height: int, width: int,
                          brc: int | None = None,
                          q8_calib_frame: torch.Tensor | None = None,
                          bgr_input: bool = False, qh8: bool = False
                          ) -> tuple[FSRGANBody, TailWeights, int]:
    """The (bf16 body, tail weights, brc) that build_fsrgan_kernel_engine
    wires together; two engines built from one set share calibration."""
    if brc is None:
        brc = 27 if q8_calib_frame is not None else 45
    body = FSRGANBody(model.body.gf, model.body.n_residual_blocks,
                      dtype=torch.bfloat16)
    return _prepare(model, body, prepare_tail, height, width, brc,
                    q8_calib_frame, bgr_input, qh8)


def prepare_mbconv_fsrgan_engine(model: FSRGANGenerator, height: int,
                                 width: int, brc: int | None = None,
                                 q8_calib_frame: torch.Tensor | None = None,
                                 bgr_input: bool = False, qh8: bool = False
                                 ) -> tuple[MBConvFSRGANBody, TailWeights,
                                            int]:
    """As :func:`prepare_fsrgan_engine`, with the body's inverted residuals
    as fused kernel launches (``build_mbconv_fsrgan_body``); the int8 tail
    is calibrated on that body's output.  Wire the result with
    :func:`build_kernel_engine`."""
    if brc is None:
        brc = 27 if q8_calib_frame is not None else 45
    body = FSRGANBody(model.body.gf, model.body.n_residual_blocks,
                      dtype=torch.bfloat16)
    return _prepare(model, body, prepare_tail, height, width, brc,
                    q8_calib_frame, bgr_input, qh8,
                    wrap=build_mbconv_fsrgan_body)


def build_srgan_kernel_engine(model: SRGANGenerator, height: int, width: int,
                              brc: int | None = None,
                              q8_calib_frame: torch.Tensor | None = None,
                              bgr: bool = False, u8_input: bool = False,
                              bgr_input: bool = False, qh8: bool = False,
                              out_uint8: bool = True):
    """SRGAN 4x: the 64-filter residual body (bf16) wired to the CIN=64
    fused tail (csrc/tail_srgan.cu), on the model's device.  Options as
    :func:`build_fsrgan_kernel_engine`; brc=None picks 27 for the int8
    modes and 15 for bf16, as the JAX engine does (1080p gives the same
    8x16 grid of 135 core rows either way)."""
    body, tail, brc = prepare_srgan_engine(model, height, width, brc,
                                           q8_calib_frame, bgr_input, qh8)
    return build_kernel_engine(body, tail, height, width, brc=brc, bgr=bgr,
                               u8_input=u8_input, out_uint8=out_uint8)


def prepare_srgan_engine(model: SRGANGenerator, height: int, width: int,
                         brc: int | None = None,
                         q8_calib_frame: torch.Tensor | None = None,
                         bgr_input: bool = False, qh8: bool = False
                         ) -> tuple[SRGANBody, TailWeights, int]:
    """The (bf16 body, tail weights, brc) that build_srgan_kernel_engine
    wires together."""
    if brc is None:
        brc = 27 if q8_calib_frame is not None else 15
    body = SRGANBody(model.body.num_res_blocks, model.body.filters,
                     dtype=torch.bfloat16)
    return _prepare(model, body, prepare_tail64, height, width, brc,
                    q8_calib_frame, bgr_input, qh8)


def _prepare(model, body, prepare, height, width, brc, q8_calib_frame,
             bgr_input, qh8, wrap=lambda body: body):
    """Load the model's body weights into `body` (a bf16 body of the same
    shape) on the model's device, flip its stem's input channels for BGR
    input (the JAX engine's _flip_stem_input_channels), pass it through
    `wrap`, and prepare the tail (qh8 if asked), calibrated on the wrapped
    body's output for the calibration frames (flipped to BGR to match the
    stem) when they are given.  qh8 without them raises ValueError."""
    if qh8 and q8_calib_frame is None:
        raise ValueError("qh8 calibrates the tail on q8_calib_frame, and "
                         "none was given")
    dev = model.tail.out_conv.weight.device
    body.load_state_dict(model.body.state_dict())
    body = body.to(dev).eval()
    if bgr_input:
        with torch.no_grad():
            body.Conv_0.weight.copy_(body.Conv_0.weight.flip(1))
    body = wrap(body)
    sample = None
    if q8_calib_frame is not None:
        frames = q8_calib_frame
        if not isinstance(frames, (list, tuple)):
            frames = [frames]
        if bgr_input:
            frames = [f.flip(-1) for f in frames]
        sample = _body_sample(body, frames, height, width, brc)
    return body, prepare(model.tail, q8_calib=sample, qh8=qh8), brc


@torch.inference_mode()
def _body_sample(body: torch.nn.Module, frames01, height: int, width: int,
                 brc: int, max_tiles: int = 16) -> torch.Tensor:
    """Body output on the leading tiles of sample frames: the calibration
    input of the w8a8 tail.  Tiles are split evenly across the frames, up to
    `max_tiles` in all."""
    if not isinstance(frames01, (list, tuple)):
        frames01 = [frames01]
    ny, nx, cr = plan_grid(height, width, brc)
    per = max(1, max_tiles // len(frames01))
    return torch.cat([body(_tiles(f, ny, nx, cr)[:per]) for f in frames01])
