"""The PyTorch half of the port tests (tests/test_torch_*.py).

tests/torch_process.py runs these functions in a child process, so that no
pytest worker imports torch.  They take and return numpy arrays and plain
Python values.  bf16 tensors travel as f32 arrays, which hold bf16 values
exactly.  Flax parameter trees arrive as nested dicts of numpy arrays and
reach the port through ``from_jax_params``.
"""

from __future__ import annotations

import contextlib
import copy
import os
from pathlib import Path

import numpy as np
import torch

from denoise_gan_tpu_torch.infer import engine as tengine
from denoise_gan_tpu_torch.infer import fast as tfast
from denoise_gan_tpu_torch.infer import kernel_engine as tke
from denoise_gan_tpu_torch.infer import tile as ttile
from denoise_gan_tpu_torch.io.params import from_jax_params
from denoise_gan_tpu_torch.models import build_generator
from denoise_gan_tpu_torch.models import fsrgan as tfsrgan
from denoise_gan_tpu_torch.models import srgan as tsrgan
from denoise_gan_tpu_torch.models import layers as tlayers
from denoise_gan_tpu_torch.models.layers import BatchNorm
from denoise_gan_tpu_torch.ops import _build
from denoise_gan_tpu_torch.ops import image as timage
from denoise_gan_tpu_torch.ops import mbconv as tmbconv
from denoise_gan_tpu_torch.ops import tail as ttail
from denoise_gan_tpu_torch.ops import tail_srgan as ttail_srgan
from denoise_gan_tpu_torch.probes import dw_forms as tdw
from denoise_gan_tpu_torch.probes import fma_peak as tfma
from denoise_gan_tpu_torch.probes import int8_chain as tdot
from denoise_gan_tpu_torch.probes import mbpipe as tmb
from denoise_gan_tpu_torch.probes import overlap as tov
from denoise_gan_tpu_torch.probes import relayout as trel
from denoise_gan_tpu_torch.probes import u8_store as tu8
from denoise_gan_tpu_torch.utils.device import require_cuda, resolve_device

DTYPES = {"f32": None, "bf16": torch.bfloat16}


def _np(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.detach().cpu().numpy()


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).bfloat16()


@contextlib.contextmanager
def _no_cuda():
    """torch.cuda.is_available() reads False inside the block."""
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        yield
    finally:
        torch.cuda.is_available = real


# ---------------------------------------------------------------------------
# ops/image.py, infer/engine.py, infer/kernel_engine.py::plan_grid

def depth_to_space(x, block):
    """(NHWC result, result of the NCHW form brought back to NHWC)."""
    t = torch.from_numpy(x)
    nchw = timage.depth_to_space_nchw(t.permute(0, 3, 1, 2), block)
    return (_np(timage.depth_to_space(t, block)),
            _np(nchw.permute(0, 2, 3, 1)))


def space_to_depth(x, block):
    return _np(timage.space_to_depth(torch.from_numpy(x), block))


def extract_grid(x, ny, nx, tile, stride):
    return _np(tengine.extract_grid(torch.from_numpy(x), ny, nx, tile,
                                    stride))


def crop_stitch(tiles, ny, nx, tile, stride):
    return _np(tengine.crop_stitch(torch.from_numpy(tiles), ny, nx, tile,
                                   stride))


def plan_grid(height, width, brc):
    return tke.plan_grid(height, width, brc=brc)


# ---------------------------------------------------------------------------
# models, io/params.py

def make_divisible(v, divisor):
    return tfsrgan._make_divisible(v, divisor)


def generator_forward(params, stats, x, dt):
    model = from_jax_params(tfsrgan.FSRGANGenerator(dtype=DTYPES[dt]).eval(),
                            params, stats)
    with torch.no_grad():
        return _np(model(torch.from_numpy(x)).float())


def body_forward(params, stats, x, dt):
    body = from_jax_params(tfsrgan.FSRGANBody(dtype=DTYPES[dt]).eval(),
                           params, stats)
    with torch.no_grad():
        return _np(body(torch.from_numpy(x)).float())


def tail_forward(params, h, dt):
    """(output, its torch dtype as a string)."""
    tail = from_jax_params(tfsrgan.FSRGANTail(dtype=DTYPES[dt]).eval(),
                           params)
    with torch.no_grad():
        out = tail(torch.from_numpy(h))
    return _np(out), str(out.dtype)


def load_generator(params, stats):
    """from_jax_params into a fresh generator; raises on a mismatch."""
    from_jax_params(tfsrgan.FSRGANGenerator(), params, stats)


def generator_layouts(params, stats):
    """InvertedResidual_1's depthwise kernel, and its BatchNorm_2 running
    variance with its dtype, after from_jax_params."""
    model = from_jax_params(tfsrgan.FSRGANGenerator(), params, stats)
    block = model.body.InvertedResidual_1
    return (_np(block.depthwise.weight), _np(block.BatchNorm_2.var),
            str(block.BatchNorm_2.var.dtype))


def batchnorm_train_forward(x):
    """A train-mode BatchNorm(4) on NHWC `x`: (output, new running mean,
    new running variance)."""
    bn = BatchNorm(x.shape[-1]).train()
    y = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return _np(y), _np(bn.mean), _np(bn.var)


def seeded_generators(seed, family="fsrgan"):
    """Two `family` generators built from one seed: (training flag of the
    first, both state dicts as numpy)."""
    a, b = (build_generator(family, device="cpu",
                            generator=torch.Generator().manual_seed(seed))
            for _ in range(2))
    return (a.training, {k: _np(v) for k, v in a.state_dict().items()},
            {k: _np(v) for k, v in b.state_dict().items()})


def build_family(family):
    build_generator(family, device="cpu")


def build_default_device_without_gpu():
    """build_generator("fsrgan") with no device, CUDA reading as absent:
    raises."""
    with _no_cuda():
        build_generator("fsrgan")


def srgan_forward(part, params, stats, x, dt, blocks=16):
    """The port's SRGAN `part` ("body", "tail" or "generator", with
    `blocks` residual blocks) loaded from Flax trees, on x."""
    dtype = DTYPES[dt]
    model = {"body": lambda: tsrgan.SRGANBody(blocks, dtype=dtype),
             "tail": lambda: tsrgan.SRGANTail(dtype=dtype),
             "generator": lambda: tsrgan.SRGANGenerator(
                 num_res_blocks=blocks, dtype=dtype)}[part]()
    from_jax_params(model.eval(), params, stats)
    with torch.no_grad():
        return _np(model(torch.from_numpy(x)).float())


def load_srgan(params, stats, scale=4, blocks=16):
    """from_jax_params into a fresh SRGAN generator (raises on a mismatch);
    its state dict as numpy."""
    model = from_jax_params(tsrgan.SRGANGenerator(scale, blocks), params,
                            stats)
    return {k: _np(v) for k, v in model.state_dict().items()}


def seeded_srgan(seed):
    """Two SRGAN generators built from one seed: (training flag of the
    first, both state dicts as numpy)."""
    a, b = (build_generator("srgan", device="cpu",
                            generator=torch.Generator().manual_seed(seed))
            for _ in range(2))
    return (a.training, {k: _np(v) for k, v in a.state_dict().items()},
            {k: _np(v) for k, v in b.state_dict().items()})


# ---------------------------------------------------------------------------
# ops/tail.py, ops/tail_srgan.py

# family: (tail module, body channels, prepare, kernel wrapper, twin,
#          launch counts, canvas wrapper, canvas twin)
_FAMILIES = {
    "fsrgan": (tfsrgan.FSRGANTail, 32, ttail.prepare_tail,
               ttail.fused_tail_u8, ttail.fused_tail_u8_reference,
               ttail.launch_counts, ttail.fused_tail_canvas,
               ttail.fused_tail_canvas_reference),
    "srgan": (tsrgan.SRGANTail, 64, ttail_srgan.prepare_tail64,
              ttail_srgan.fused_tail64_u8,
              ttail_srgan.fused_tail64_u8_reference,
              ttail_srgan.launch_counts, ttail_srgan.fused_tail64_canvas,
              ttail_srgan.fused_tail64_canvas_reference),
}


def _fired(before: dict, after: dict) -> dict:
    """The launch counts that moved between two snapshots."""
    return {k: after[k] - before[k] for k in before if after[k] != before[k]}


def _tail(params, family="fsrgan"):
    return from_jax_params(_FAMILIES[family][0]().eval(), params)


def q8_weights(params, family="fsrgan"):
    return ttail.prep_weights_q8(ttail.prep_weights(_tail(params, family)))


def calibrate(params, h, family="fsrgan"):
    """(calibrate_tail_scales at Q8_MARGIN, Q8_MARGIN)."""
    scales = ttail.calibrate_tail_scales(_tail(params, family), _bf16(h),
                                         margin=ttail.Q8_MARGIN)
    return scales, ttail.Q8_MARGIN


def _tail_weights(params, ht, mode, family):
    """The family's TailWeights in `mode` (bf16, w8a8 or qh8); the int8
    modes calibrate on the bf16 tiles ht themselves."""
    prepare = _FAMILIES[family][2]
    calib = None if mode == "bf16" else ht
    return prepare(_tail(params, family), q8_calib=calib, qh8=mode == "qh8")


def twin(params, h, ny, nx, height, width, q8=False, bgr=False,
         family="fsrgan", mode=None, canvas=False):
    """The twin's frame (u8, or with `canvas` the bf16 canvas as f32) and
    whether the weights were int8.  mode (bf16, w8a8, qh8) defaults to
    w8a8 when q8 else bf16; the int8 modes calibrate on h itself, and qh8
    quantises h with quantize_h."""
    twin_fn = _FAMILIES[family][7 if canvas else 4]
    ht = _bf16(h)
    tw = _tail_weights(params, ht, mode or ("w8a8" if q8 else "bf16"),
                       family)
    if tw.qh8:
        ht = ttail.quantize_h(ht, tw)
    return _np(twin_fn(ht, tw, ny, nx, height, width, bgr)), tw.q8


def h_scales(h):
    """calibrate_h_scales of the bf16 tiles h at Q8_MARGIN."""
    return ttail.calibrate_h_scales(_bf16(h), margin=ttail.Q8_MARGIN)


def qh8_weights(params, h, family="fsrgan"):
    """The qh8 TailWeights' up1 calibrated on h: w1 unpacked to (9C, 4C)
    int8 (k = (dy*3 + dx)*C + cin), s1 (4C,) and inv_sh (C,)."""
    tw = _tail_weights(params, _bf16(h), "qh8", family)
    w1 = tw.w1.permute(0, 2, 1).reshape(-1, tw.w1.shape[1])
    return dict(w1=_np(w1), s1=_np(tw.s1), inv_sh=_np(tw.inv_sh),
                mode=tw.mode, h_dtype=str(tw.h_dtype))


def quantized_h(params, h, family="fsrgan"):
    """quantize_h of the bf16 tiles h, with qh8 weights calibrated on h."""
    ht = _bf16(h)
    return _np(ttail.quantize_h(ht, _tail_weights(params, ht, "qh8",
                                                  family)))


def wrapper_on_cpu(params, h, ny, nx, height, width, family="fsrgan"):
    """(wrapper's frame, twin's frame, launch-count increments)."""
    _, _, prepare, kernel, twin_fn, counts = _FAMILIES[family][:6]
    ht = _bf16(h)
    tw = prepare(_tail(params, family))
    before = dict(counts)
    got = kernel(ht, tw, ny, nx, height, width)
    want = twin_fn(ht, tw, ny, nx, height, width)
    return got.numpy(), want.numpy(), _fired(before, counts)


def wrapper_off_cpu_without_cuda(params, ny, nx, core_rows, height, width,
                                 family="fsrgan"):
    """Call the wrapper on a tensor that is not on the CPU, with CUDA
    reading as absent: raises."""
    _, cin, prepare, kernel = _FAMILIES[family][:4]
    tw = prepare(_tail(params, family), device="meta")
    h = torch.empty((ny * nx, core_rows + 4, ttail.T, cin),
                    dtype=torch.bfloat16, device="meta")
    with _no_cuda():
        kernel(h, tw, ny, nx, height, width)


def prepare_tail64_of(family, scale=4):
    """prepare_tail64 on a seeded tail of `family` (SRGAN at `scale`);
    raises for a tail it does not take."""
    tail = (tsrgan.SRGANTail(scale) if family == "srgan"
            else tfsrgan.FSRGANTail())
    ttail_srgan.prepare_tail64(tail.eval())


def _exact_sum_case(ny, nx, core_rows, seed, dyadic):
    """A seeded SRGAN tail and bf16 h of (ny*nx, core_rows+4, 124, 64):
    with `dyadic`, up1 and h on ops/tail_srgan.py's exact-sum grid, else
    h ~ N(0, 0.25)."""
    gen = torch.Generator().manual_seed(seed)
    tail = _seeded_tail("srgan", gen)
    shape = (ny * nx, core_rows + 4, ttail.T, ttail_srgan.CIN)
    if not dyadic:
        return tail, (torch.randn(shape, generator=gen) * 0.5).bfloat16()
    ttail_srgan.dyadic_up1_(tail, gen)
    return tail, ttail_srgan.dyadic_h(shape, gen)


@torch.no_grad()
def exact_sum_up1(ny, nx, core_rows, seed=0):
    """up1's sums as the twin takes them (ops/tail.py::_up1_sum, f32 in
    K1's order) against the same sums in float64 rounded once to f32, on
    exact-sum inputs and on N(0, 0.25) h: {case: (number of up1 values
    that differ, max |sum|)}."""
    out = {}
    for case in ("gaussian", "dyadic"):
        tail, h = _exact_sum_case(ny, nx, core_rows, seed, case == "dyadic")
        w1 = ttail_srgan.prepare_tail64(tail).conv_weights()[0]
        x = h.float().permute(0, 3, 1, 2)
        s32 = ttail._up1_sum(x, w1)
        s64 = torch.nn.functional.conv2d(x.double(), w1.double(), padding=1)
        out[case] = (int((s32 != s64.float()).sum()),
                     float(s64.abs().max()))
    return out


def _up1_sum_reversed(x, w1):
    """ops/tail.py::_up1_sum with the taps and input channels in reverse
    order."""
    n, c, hh, ww = x.shape
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1))
    acc = x.new_zeros((n, w1.shape[0], hh, ww))
    for dy in reversed(range(3)):
        for dx in reversed(range(3)):
            for ci in reversed(range(c)):
                acc.addcmul_(xp[:, ci:ci + 1, dy:dy + hh, dx:dx + ww],
                             w1[:, ci, dy, dx].view(1, -1, 1, 1))
    return acc


def exact_sum_twin_orders(ny, nx, core_rows, seed=0):
    """The w8a8 SRGAN twin's u8 frame on exact-sum inputs (int8 scales
    calibrated on that h), with up1 summed as ops/tail.py::_up1_sum and
    with its order reversed: (frame, reversed-order frame, the smallest
    per-channel std of the frame)."""
    tail, h = _exact_sum_case(ny, nx, core_rows, seed, True)
    tw = ttail_srgan.prepare_tail64(tail, q8_calib=h)
    args = (h, tw, ny, nx, ny * core_rows, nx * ttail.CORE)
    want = ttail_srgan.fused_tail64_u8_reference(*args)
    summed = ttail._up1_sum
    ttail._up1_sum = _up1_sum_reversed
    try:
        got = ttail_srgan.fused_tail64_u8_reference(*args)
    finally:
        ttail._up1_sum = summed
    return _np(want), _np(got), float(want.float().std(dim=(0, 1)).min())


# csrc/tail.cu's index maps (ops/tail.py) against the twin's convolutions

def _d2s_block(x, row0, col0, rows, cols):
    """x (C, H, W) at rows row0.. and cols col0.. (zero outside x), as
    (rows, cols, C)."""
    c, hh, ww = x.shape
    out = x.new_zeros((rows, cols, c))
    ys = torch.arange(row0, row0 + rows)
    xs = torch.arange(col0, col0 + cols)
    ok_y, ok_x = (ys >= 0) & (ys < hh), (xs >= 0) & (xs < ww)
    sub = x[:, ys[ok_y]][:, :, xs[ok_x]].permute(1, 2, 0)
    out[ok_y.nonzero()[:, 0][:, None], ok_x.nonzero()[:, 0][None, :]] = sub
    return out


@torch.no_grad()
def k1_index_maps(mode, core_rows=24, seed=0):
    """The kernel's GEMMs through ops/tail.py's index maps on one seeded
    tile of `core_rows` core rows (int8 modes: w8a8, qh8), against the
    twin's convolutions, at each block (r0, c0) in the tile's first and
    last band and column chunk: up2's sums from u1 rows gathered by
    up2_rows times W2, and the output conv's from R rows gathered by
    out_rows (R's bf16-derived copy where it says so) times W3 unpacked
    from out_w3_fragments, both in int64.  Returns {"up2": (values
    compared, values that differ), "out": (...), "pad": the padded B
    columns' largest |word|}."""
    gen = torch.Generator().manual_seed(seed)
    tail = _seeded_tail("fsrgan", gen)
    h = (torch.randn((1, core_rows + 4, ttail.T, 32), generator=gen)
         * 0.5).bfloat16()
    tw = ttail.prepare_tail(tail, q8_calib=h, qh8=mode == "qh8")
    x = (ttail.quantize_h(h, tw) if tw.qh8 else h).float().permute(0, 3, 1, 2)
    w1, w2, w3 = tw.conv_weights()
    bias = ttail._bias
    with ttail._exact_f32():
        c1 = (ttail._conv(x, w1) * bias(tw.s1) if tw.qh8
              else ttail._up1_sum(x, w1)) + bias(tw.b1)
        u1 = ttail._quant(ttail._prelu(timage.depth_to_space_nchw(c1, 2),
                                       tw.a1), tw.inv_su1)
        s2 = ttail._conv(u1, w2)
        r = ttail._prelu(timage.depth_to_space_nchw(
            s2 * bias(tw.s2) + bias(tw.b2), 2), tw.a2)
        rq = ttail._quant(r, tw.inv_sr)
        rbq = ttail._quant(ttail._bf16(r), tw.inv_sr)
        s3 = ttail._conv(rq, w3) + ttail._edge_taps(rbq - rq, w3)
    br, bc = ttail.BLOCK
    w2t = w2.permute(2, 3, 1, 0).reshape(9, 32, 128).long()    # [tap][c][q]
    frag = torch.from_numpy(ttail.out_w3_fragments(tw).astype(np.int64))
    # word w of lane (g, t): int8 k = 4t.. (+16 for word 1) of column g
    b3 = torch.zeros((9, 32, 8), dtype=torch.long)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for word in range(2):
            for byte in range(4):
                v = (frag[:, lane, word] >> (8 * byte)) & 0xff
                b3[:, 16 * word + 4 * t + byte, g] = v - 256 * (v > 127)
    up2_idx = torch.from_numpy(ttail.up2_rows())
    out_idx = torch.from_numpy(ttail.out_rows())
    th2, tw2 = 2 * (core_rows + 4), 2 * ttail.T
    th4, tw4 = 2 * th2, 2 * tw2
    got = {"up2": [0, 0], "out": [0, 0]}
    for r0 in (0, (core_rows - 1) // br * br):
        for c0 in (0, ttail.CORE - bc):
            # u1 rows: position (i, j), channels ph*32 + t, from d1
            d1 = _d2s_block(u1[0], 2 * (r0 + 1), 2 * (c0 + 1),
                            2 * (br + 2), 2 * (bc + 2))
            u = d1.reshape(br + 2, 2, bc + 2, 2, 32).permute(0, 2, 1, 3, 4)
            u = u.reshape((br + 2) * (bc + 2), 128).long()
            a = u.view(-1, 4, 32)[up2_idx[..., 0], up2_idx[..., 1]]
            sums = torch.einsum("ptc,tcq->pq", a, w2t)
            y, xx = np.divmod(np.arange(sums.shape[0]), 2 * bc + 2)
            y, xx = torch.from_numpy(y), torch.from_numpy(xx)
            ty, tx = 2 * r0 + 3 + y, 2 * c0 + 3 + xx
            inside = (ty < th2) & (tx < tw2)
            want = s2[0][:, ty[inside], tx[inside]].t().long()
            got["up2"][0] += want.numel()
            got["up2"][1] += int((sums[inside] != want).sum())
            # R rows from the twin's R, (rho, kappa) = fine (4r0+6+rho, ..)
            rr, rc = 4 * br + 4, 4 * bc + 4
            rs = _d2s_block(rq[0], 4 * r0 + 6, 4 * c0 + 6, rr, rc).long()
            rb = _d2s_block(rbq[0], 4 * r0 + 6, 4 * c0 + 6, rr, rc).long()
            rows = torch.where(out_idx[..., 2:3].bool(),
                               rb[out_idx[..., 0], out_idx[..., 1]],
                               rs[out_idx[..., 0], out_idx[..., 1]])
            sums = torch.einsum("ptc,tcn->pn", rows, b3)
            oy, ox = np.divmod(np.arange(sums.shape[0]), 4 * bc)
            oy, ox = torch.from_numpy(oy), torch.from_numpy(ox)
            fy, fx = 8 + 4 * r0 + oy, 8 + 4 * c0 + ox
            inside = (fy < th4 - 8) & (fx < tw4 - 8) & (oy + 4 * r0 <
                                                        4 * core_rows)
            want = s3[0][:, fy[inside], fx[inside]].t().long()
            got["out"][0] += want.numel()
            got["out"][1] += int((sums[inside][:, :3] != want).sum())
    got = {k: tuple(v) for k, v in got.items()}
    got["pad"] = int(b3[..., 3:].abs().max())
    return got


def k1_chunk_rows():
    """ops/tail.py::chunk_rows as lists, and the kernel's block rows."""
    return ([(list(w), list(o)) for w, o in ttail.chunk_rows()],
            ttail.BLOCK[0], ttail.CHUNK)


def k1_w3_fragments_bf16(seed=0):
    """out_w3_fragments of bf16 tail weights unpacked: (the (18, 16, 8)
    B matrices of the k-steps as f32, w3 (288, 3) as f32)."""
    gen = torch.Generator().manual_seed(seed)
    tw = ttail.prepare_tail(_seeded_tail("fsrgan", gen))
    frag = ttail.out_w3_fragments(tw)
    b = np.zeros((18, 16, 8), np.float32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for word in range(2):
            for half in range(2):
                bits = (frag[:, lane, word] >> (16 * half)) & 0xffff
                b[:, 8 * word + 2 * t + half, g] = (
                    bits.astype(np.uint32) << 16).view(np.float32)
    return b, _np(tw.w3)


def up1_sum_errors(k, one_sign, rows=256, cols=32, seed=0):
    """f32 sums of k bf16 products one at a time in the twin's order
    (ops/tail.py::_up1_sum's addcmul) against the float64 sum: the largest
    |error| relative to sum |x w| and to |x| |w|, and ops/tail.py::up1_err
    (k).  Inputs N(0, 1), or their magnitudes with `one_sign`."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, k), generator=gen).bfloat16().float()
    w = torch.randn((k, cols), generator=gen).bfloat16().float()
    if one_sign:
        x, w = x.abs(), w.abs()
    acc = torch.zeros((rows, cols))
    for i in range(k):
        acc.addcmul_(x[:, i:i + 1], w[i:i + 1])
    xd, wd = x.double(), w.double()
    err = (acc.double() - xd @ wd).abs()
    return (float((err / (xd.abs() @ wd.abs())).max()),
            float((err / (xd.norm(dim=1, keepdim=True)
                          * wd.norm(dim=0, keepdim=True))).max()),
            ttail.up1_err(k))


def up1_certain_on_cpu():
    """ops/tail.py::up1_certain on CPU tensors: it has no plain version and
    must raise."""
    z = torch.zeros(4)
    return ttail.up1_certain(z, z, z, z, 1.0, True)


@torch.no_grad()
def one_sign_inputs(family, ny=1, nx=1, core_rows=7, seed=0):
    """ops/tail.py's one-sign inputs for `family`: (the smallest up1 weight,
    the smallest h, the smallest per-channel std of the w8a8 twin's u8
    frame with its int8 scales calibrated on that h)."""
    gen = torch.Generator().manual_seed(seed)
    tail = ttail.one_sign_up1_(_seeded_tail(family, gen))
    cin, prepare = _FAMILIES[family][1:3]
    h = ttail.one_sign_h((ny * nx, core_rows + 4, ttail.T, cin), gen)
    tw = prepare(tail, q8_calib=h)
    frame = _FAMILIES[family][4](h, tw, ny, nx, ny * core_rows,
                                 nx * ttail.CORE)
    return (float(tail.up1.Conv_0.weight.min()), float(h.float().min()),
            float(frame.float().std(dim=(0, 1)).min()))


def cuda_requests_without_gpu():
    """With CUDA absent: the messages of require_cuda() and
    resolve_device("cuda") (None if one did not raise RuntimeError), and
    resolve_device("cpu") as a string."""
    messages = []
    with _no_cuda():
        for request in (require_cuda, lambda: resolve_device("cuda")):
            try:
                request()
                messages.append(None)
            except RuntimeError as e:
                messages.append(str(e))
        return messages, str(resolve_device("cpu"))


def build_without_nvcc(empty_dir):
    """load_library() with no nvcc anywhere (CUDA_HOME, PATH and the
    default home all point at `empty_dir`); raises."""
    saved = {k: os.environ.get(k) for k in ("CUDA_HOME", "PATH")}
    attrs = {k: getattr(_build, k)
             for k in ("DEFAULT_CUDA_HOME", "BUILD_DIR", "_lib")}
    os.environ.update(CUDA_HOME=empty_dir, PATH=empty_dir)
    _build.DEFAULT_CUDA_HOME = empty_dir
    _build.BUILD_DIR = Path(empty_dir) / "build"
    _build._lib = None
    try:
        _build.load_library()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for k, v in attrs.items():
            setattr(_build, k, v)


def wrapper_bad_input(params, h, ny, nx, height, width, bad,
                      family="fsrgan"):
    """Call the wrapper with one input spoilt as `bad` names; raises.
    "canvas_bgr": the canvas wrapper asked for BGR; "<mode>_<dtype>_h": h
    of a dtype that the mode's weights do not take."""
    _, _, prepare, kernel = _FAMILIES[family][:4]
    ht = _bf16(h)
    args = dict(h=ht, tw=prepare(_tail(params, family)), ny=ny, nx=nx,
                height=height, width=width)
    if bad == "canvas_bgr":
        kernel = _FAMILIES[family][6]
        args["bgr"] = True
    elif bad.endswith("_h"):
        mode, dtype = bad.split("_")[:2]
        args["tw"] = _tail_weights(params, ht, mode, family)
        args["h"] = ht.to(getattr(torch, dtype))
    elif bad == "weights":      # the other family's tail weights
        other = "srgan" if family == "fsrgan" else "fsrgan"
        gen = torch.Generator().manual_seed(0)
        args["tw"] = _FAMILIES[other][2](
            _FAMILIES[other][0](generator=gen).eval())
    elif bad == "dtype":
        args["h"] = ht.float()
    elif bad == "width":
        args["h"] = ht[:, :, :120]
    elif bad == "tiles":
        args["nx"] = nx + 1
    elif bad == "frame":
        args["width"] = width + 1
    elif bad == "layout":
        args["h"] = ht.transpose(1, 2).contiguous().transpose(1, 2)
    kernel(**args)


# ---------------------------------------------------------------------------
# ops/mbconv.py

def _mbconv_weights(w, dt, residual=True, device="cpu"):
    """MBConvWeights from a dict of f32 arrays (no "we"/"be": no expand)."""
    def t(k):
        return None if w.get(k) is None else \
            torch.from_numpy(w[k]).to(device, DTYPES[dt] or torch.float32)

    return tmbconv.MBConvWeights(we=t("we"), be=t("be"), wd=t("wd"),
                                 bd=t("bd"), wp=t("wp"), bp=t("bp"),
                                 residual=residual)


def mbconv_reference(x, w, dt):
    """fused_mbconv_reference on x (f32 array, cast to `dt`) as f32."""
    xt = torch.from_numpy(x).to(DTYPES[dt] or torch.float32)
    return _np(tmbconv.fused_mbconv_reference(xt, _mbconv_weights(w, dt)))


def mbconv_prepare(params, stats, idx):
    """prepare_mbconv (f32) of the body's InvertedResidual_<idx>: its
    weights as f32 arrays (None for an absent expand) and residual flag."""
    body = from_jax_params(tfsrgan.FSRGANBody().eval(), params, stats)
    w = tmbconv.prepare_mbconv(getattr(body, f"InvertedResidual_{idx}"),
                               torch.float32)
    return ({k: None if getattr(w, k) is None else _np(getattr(w, k))
             for k in ("we", "be", "wd", "bd", "wp", "bp")}, w.residual)


def mbconv_body_forward(params, stats, x, dt):
    """build_mbconv_fsrgan_body of a `dt` FSRGANBody on x (CPU: the plain
    block), and the increments of the block's launch counts."""
    body = from_jax_params(tfsrgan.FSRGANBody(dtype=DTYPES[dt]).eval(),
                           params, stats)
    fused = tmbconv.build_mbconv_fsrgan_body(body)
    before = dict(tmbconv.launch_counts)
    with torch.no_grad():
        out = fused(torch.from_numpy(x))
    return _np(out), str(out.dtype), {
        k: tmbconv.launch_counts[k] - before[k] for k in before}


def mbconv_wrapper_on_cpu(x, w, dt):
    """(wrapper's output, plain version's output, launch-count
    increments)."""
    xt = torch.from_numpy(x).to(DTYPES[dt] or torch.float32)
    mw = _mbconv_weights(w, dt)
    before = dict(tmbconv.launch_counts)
    got = tmbconv.fused_mbconv(xt, mw)
    want = tmbconv.fused_mbconv_reference(xt, mw)
    return _np(got), _np(want), {
        k: tmbconv.launch_counts[k] - before[k] for k in before}


def mbconv_wrapper_bad_input(x, w, bad):
    """Call the wrapper with x spoilt as `bad` names ("channels": one
    channel short; "meta": off the CPU with CUDA reading as absent);
    raises."""
    if bad == "meta":
        with _no_cuda():
            tmbconv.fused_mbconv(
                torch.empty(x.shape, dtype=torch.bfloat16, device="meta"),
                _mbconv_weights(w, "bf16", device="meta"))
    tmbconv.fused_mbconv(torch.from_numpy(x[..., 1:]).bfloat16(),
                         _mbconv_weights(w, "bf16"))


def _seq_sum(a: torch.Tensor, w: torch.Tensor, order: str, err: float = 0.0
             ) -> torch.Tensor:
    """f32 sums over the last axis of a against w's rows, in `order`:
    "plain" (one product at a time, index 0 up, as the plain version),
    "reversed" (index K-1 down), "f64" (exact in float64, rounded once),
    "allowance" (the exact sum moved by 0.9 err |a| |w|, the sign drawn
    per sum from a fixed seed: a tensor core at the edge of the allowance
    err)."""
    if order in ("f64", "allowance"):
        exact = a.double() @ w.double()
        if order == "allowance":
            sign = torch.randint(0, 2, exact.shape, generator=torch.Generator(
                ).manual_seed(7)).double() * 2 - 1
            exact = exact + sign * 0.9 * err * a.double().norm(
                dim=-1, keepdim=True) * w.double().norm(dim=0)
        return exact.float()
    acc = a.new_zeros(a.shape[:-1] + (w.shape[1],))
    idx = range(a.shape[-1])
    for i in (reversed(idx) if order == "reversed" else idx):
        acc.addcmul_(a[..., i:i + 1], w[i])
    return acc


def _margin_rows(x, w, order):
    """The K3 kernel's route in plain PyTorch, with its tensor-core sums
    taken in `order` instead: (counts, the routed output, the plain
    version's output)."""
    xf = x.float()
    hh, ww = x.shape[1:3]
    out = {}
    if w.has_expand:
        we = w.we.float()
        s_plain = _seq_sum(xf, we, "plain")
        s_alt = _seq_sum(xf, we, order, tmbconv.ERR_MMA_EXPAND)
        exact = xf.double() @ we.double()
        norm = xf.double().norm(dim=-1, keepdim=True) * we.double().norm(dim=0)
        out["premise_e"] = int(((s_alt.double() - exact).abs()
                                > tmbconv.ERR_MMA_EXPAND * norm).sum())
        e_plain = torch.relu(s_plain + w.be.float())
        e_alt = torch.relu(s_alt + w.be.float())
    else:
        e_plain = e_alt = xf

    def depthwise(e):
        ep = torch.nn.functional.pad(e, (0, 0, 1, 1, 1, 1))
        acc = torch.zeros_like(e)
        for dr in range(3):
            for dc in range(3):
                tap = ep[:, dr:dr + hh, dc:dc + ww]
                acc = acc + tap * w.wd.float()[dr, dc]
        return acc + w.bd.float()

    v_plain, v_alt = depthwise(e_plain), depthwise(e_alt)

    def to_d(v):
        return torch.relu(v).to(x.dtype).float()

    d_plain, d_alt = to_d(v_plain), to_d(v_alt)
    sure = tmbconv.certain(v_alt, tmbconv.d_margin(x, w, e_alt), relu=True) \
        if w.has_expand else torch.ones_like(v_alt, dtype=torch.bool)
    out.update(d_values=d_alt.numel(), d_uncertain=int((~sure).sum()),
               d_apart=int((d_alt != d_plain).sum()),
               d_wrong=int((sure & (d_alt != d_plain)).sum()))
    d = torch.where(sure, d_alt, d_plain)      # the repair: the plain order

    wp = w.wp.float()
    p_plain = _seq_sum(d, wp, "plain")
    p_alt = _seq_sum(d, wp, order, tmbconv.ERR_MMA_PROJECT)
    exact = d.double() @ wp.double()
    norm = d.double().norm(dim=-1, keepdim=True) * wp.double().norm(dim=0)
    out["premise_p"] = int(((p_alt.double() - exact).abs()
                            > tmbconv.ERR_MMA_PROJECT * norm).sum())

    def to_y(p):
        y = p + w.bp.float()
        return y + xf if w.residual else y

    y_plain, y_alt = to_y(p_plain), to_y(p_alt)
    sure = tmbconv.certain(y_alt, tmbconv.y_margin(d, x, w), relu=False)
    yb_plain, yb_alt = y_plain.to(x.dtype), y_alt.to(x.dtype)
    out.update(y_values=y_alt.numel(), y_uncertain=int((~sure).sum()),
               y_apart=int((yb_alt != yb_plain).sum()),
               y_wrong=int((sure & (yb_alt != yb_plain)).sum()))
    return out, torch.where(sure, yb_alt, yb_plain), yb_plain


def mbconv_margin_case(seed, expand, one_sign, order):
    """The K3 kernel's margin tests (ops/mbconv.py: d_margin, y_margin,
    certain) on a seeded block and x (2, 16, 20, 32) bf16, or their
    one-sign forms (one_sign_x, one_sign_block), with the expand and the
    project summed in `order` ("f64", "reversed", "allowance": _seq_sum)
    where the kernel uses the tensor cores: a dict of counts (values,
    uncertain, apart from the plain version, apart where the test says
    certain; sums beyond the tensor core's allowance) and whether the
    routed output (certain values from the other order, the rest in the
    plain order) equals fused_mbconv_reference bit for bit."""
    gen = torch.Generator().manual_seed(seed)
    w = _seeded_block(gen, expand, "cpu")
    shape = (2, 16, 20, 32)
    if one_sign:
        x = tmbconv.one_sign_x(shape, gen)
        w = tmbconv.one_sign_block(w, x)
    else:
        x = (torch.randn(shape, generator=gen) * 0.5).bfloat16()
    with torch.no_grad():
        out, routed, plain = _margin_rows(x, w, order)
        want = tmbconv.fused_mbconv_reference(x, w)
    out["plain_is_reference"] = bool(torch.equal(plain, want))
    out["routed_is_reference"] = bool(torch.equal(routed, want))
    return out


def mbconv_margin_parts():
    """ops/mbconv.py::margin_parts()."""
    return tmbconv.margin_parts()


def mbconv_one_sign(seed):
    """one_sign_x and one_sign_block on a seeded expanding block: whether
    every expand, depthwise and project weight and every x is >= 0, the
    means over x of the expand's and the project's sums plus their biases
    (near 0: the bias cancels them) against the sums' mean size, and the
    share of d values that ReLU keeps."""
    gen = torch.Generator().manual_seed(seed)
    x = tmbconv.one_sign_x((2, 16, 20, 32), gen)
    w = tmbconv.one_sign_block(_seeded_block(gen, True, "cpu"), x)
    with torch.no_grad():
        s = x.float() @ w.we.float()
        y = tmbconv.fused_mbconv_reference(x, w).float() - x.float()
        p = y - w.bp.float()
    return dict(
        nonneg=bool((x >= 0).all() and (w.we >= 0).all()
                    and (w.wd >= 0).all() and (w.wp >= 0).all()),
        s_mean=float((s + w.be.float()).mean()), s_size=float(s.mean()),
        p_mean=float((p + w.bp.float()).mean()), p_size=float(p.mean()),
        dtype=str(w.be.dtype))


# ---------------------------------------------------------------------------
# infer/kernel_engine.py

_BUILDERS = {"fsrgan": (tfsrgan.FSRGANGenerator,
                        tke.build_fsrgan_kernel_engine),
             "srgan": (tsrgan.SRGANGenerator, tke.build_srgan_kernel_engine)}


def _generator(params, stats, family="fsrgan"):
    return from_jax_params(_BUILDERS[family][0]().eval(), params, stats)


def _launch_counts():
    return {**ttail.launch_counts, **ttail_srgan.launch_counts}


def engine_frames(params, stats, height, width, brc, frames, calib=None,
                  bgr=False, family="fsrgan", u8_input=False,
                  bgr_input=False, calib_frames=None, qh8=False,
                  out_uint8=True):
    """The family's kernel engine's output for each frame (float [0, 1],
    or uint8 with u8_input), and the launch counts of both tails that
    moved.  w8a8 (qh8 with `qh8`) when `calib`, the index of the
    calibration frame in `calib_frames` (default `frames`), is given."""
    calib_frames = frames if calib_frames is None else calib_frames
    q8_frame = None if calib is None else torch.from_numpy(
        calib_frames[calib])
    run = _BUILDERS[family][1](_generator(params, stats, family), height,
                               width, brc=brc, q8_calib_frame=q8_frame,
                               bgr=bgr, u8_input=u8_input,
                               bgr_input=bgr_input, qh8=qh8,
                               out_uint8=out_uint8)
    before = _launch_counts()
    outs = [run(torch.from_numpy(f)).numpy() for f in frames]
    return outs, _fired(before, _launch_counts())


def mbconv_engine_frames(params, stats, height, width, brc, frames,
                         calib=None, qh8=False):
    """The K3-body FSRGAN engine (prepare_mbconv_fsrgan_engine wired by
    build_kernel_engine) on each frame, w8a8 (qh8 with `qh8`) calibrated on
    frames[calib] when it is given; and the launch counts that moved."""
    q8_frame = None if calib is None else torch.from_numpy(frames[calib])
    body, tw, brc = tke.prepare_mbconv_fsrgan_engine(
        _generator(params, stats), height, width, brc=brc,
        q8_calib_frame=q8_frame, qh8=qh8)
    run = tke.build_kernel_engine(body, tw, height, width, brc=brc)
    before = {**_launch_counts(), **tmbconv.launch_counts}
    outs = [run(torch.from_numpy(f)).numpy() for f in frames]
    return outs, _fired(before, {**_launch_counts(), **tmbconv.launch_counts})


def chip_smoke_trees(family):
    """The Flax-layout (params, batch_stats) trees of the seeded generator
    that chip_smoke.py drives on the card for `family` (its seed, its
    order of families)."""
    import chip_smoke

    rng = np.random.default_rng(chip_smoke.SEED)
    trees = {}
    for fam in chip_smoke.FAMILIES:
        model = build_generator(fam.name, device="cpu")
        trees[fam.name] = chip_smoke.seeded_flax_tree(
            model, rng, fam.body_gain, fam.out_gain)
    return trees[family]


def chip_smoke_jax_init_trees(family):
    """chip_smoke.py's numpy draw of the JAX package's initialisers for
    `family` (phase 4d's JAX-init weights, at its seed)."""
    import chip_smoke

    model = build_generator(family, device="cpu")
    return chip_smoke.jax_init_tree(model, np.random.default_rng(
        chip_smoke.SEED), family)


def whole_frame_and_engines(params, stats, frame, brc, family="fsrgan"):
    """chip_smoke.py's exact whole-frame output of `frame` (the plain bf16
    generator) and the family's engine outputs on it in bf16, w8a8 and qh8
    (the int8 modes calibrated on the frame), as uint8 arrays."""
    import chip_smoke

    fam = next(f for f in chip_smoke.FAMILIES if f.name == family)
    model = _generator(params, stats, family)
    f = torch.from_numpy(frame)
    height, width = frame.shape[:2]
    outs = {}
    for mode, kw in (("bf16", {}), ("w8a8", {"q8_calib_frame": f}),
                     ("qh8", {"q8_calib_frame": f, "qh8": True})):
        outs[mode] = fam.build(model, height, width, brc=brc, **kw)(f).numpy()
    return chip_smoke.exact_frame(fam, model, f).numpy(), outs


def engine_qh8_without_calibration(params, stats, height, width, brc,
                                   family="fsrgan"):
    """Build the family's engine with qh8 and no calibration frame;
    raises."""
    _BUILDERS[family][1](_generator(params, stats, family), height, width,
                         brc=brc, qh8=True)


def engine_tiles(frame, height, width, brc):
    """The engine's bf16 input tiles of a float or uint8 frame, as f32."""
    ny, nx, cr = tke.plan_grid(height, width, brc)
    return _np(tke._tiles(torch.from_numpy(frame), ny, nx, cr))


def engine_wrong_frame(params, stats, height, width, brc):
    """Run the engine on a frame one column too wide; raises."""
    run = tke.build_fsrgan_kernel_engine(_generator(params, stats), height,
                                         width, brc=brc)
    run(torch.zeros(height, width + 1, 3))


def body_samples(params, stats, height, width, brc, frames):
    """_body_sample of the first frame alone and of all frames."""
    body = _generator(params, stats).body
    f = [torch.from_numpy(x) for x in frames]
    one = tke._body_sample(body, f[0], height, width, brc)
    both = tke._body_sample(body, f, height, width, brc)
    return _np(one), _np(both)


# ---------------------------------------------------------------------------
# csrc/tail.cu and csrc/tail_srgan.cu on the card

_CUDA_TAILS = {}


def process_id() -> int:
    """The child process's id."""
    return os.getpid()


def cuda_available():
    return torch.cuda.is_available()


@torch.no_grad()
def _seeded_tail(family, gen):
    """A tail of `family` on the CPU drawn from `gen`.  Biases and slopes
    are redrawn; SRGAN's N(0, 0.02) kernels are redrawn at N(0, 1/fan_in)
    so that the output is not flat."""
    tail = _FAMILIES[family][0](generator=gen).eval()
    for name, p in tail.named_parameters():
        if name.endswith("alpha"):
            p.uniform_(0.05, 0.3, generator=gen)
        elif name.endswith("bias"):
            p.normal_(0.0, 0.05, generator=gen)
        elif family == "srgan":
            p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
    return tail


def _cuda_tails(family):
    """bf16, w8a8 and qh8 TailWeights of a seeded tail of `family`
    (_seeded_tail) on the card."""
    if family not in _CUDA_TAILS:
        cin, prepare = _FAMILIES[family][1:3]
        gen = torch.Generator().manual_seed(0)
        tail = _seeded_tail(family, gen).to("cuda")
        calib = (torch.randn((4, 28, ttail.T, cin), generator=gen)
                 * 0.5).to("cuda", torch.bfloat16)
        _CUDA_TAILS[family] = dict(
            bf16=prepare(tail), w8a8=prepare(tail, q8_calib=calib),
            qh8=prepare(tail, q8_calib=calib, qh8=True))
    return _CUDA_TAILS[family]


def cuda_kernel_vs_twin(ny, nx, core_rows, height, width, mode, bgr,
                        family="fsrgan", canvas=False):
    """The tail kernel of `family` (u8, or with `canvas` the canvas
    epilogue) and its twin on one seeded h on the card (qh8: h through
    quantize_h): a dict of the kernel's output shape, dtype and device, its
    launch-count increment, the max |difference| (u8 levels, or for the
    canvas tanh's units) and the share of outputs that differ, and the
    smallest per-channel std of the output on the u8 scale."""
    fam = _FAMILIES[family]
    cin = fam[1]
    gen = torch.Generator().manual_seed(core_rows * 1000 + width)
    h = (torch.randn((ny * nx, core_rows + 4, ttail.T, cin), generator=gen)
         * 0.5).to("cuda", torch.bfloat16)
    tw = _cuda_tails(family)[mode]
    if tw.qh8:
        h = ttail.quantize_h(h, tw)
    return _kernel_vs_twin(family, (h, tw, ny, nx, height, width, bgr),
                           canvas)


def cuda_exact_sum_w8a8(ny, nx, core_rows, height, width, canvas=False,
                        family="srgan"):
    """As :func:`cuda_kernel_vs_twin` for the tail of `family` in w8a8 (u8
    RGB, or the canvas), on inputs where every f32 partial sum of up1 is
    exact in any order (ops/tail_srgan.py::dyadic_up1_ and dyadic_h, the
    int8 scales calibrated on that h)."""
    gen = torch.Generator().manual_seed(core_rows * 1000 + width)
    tail = _seeded_tail(family, gen)
    ttail_srgan.dyadic_up1_(tail, gen)
    cin, prepare = _FAMILIES[family][1:3]
    h = ttail_srgan.dyadic_h((ny * nx, core_rows + 4, ttail.T, cin), gen,
                             "cuda")
    tw = prepare(tail.to("cuda"), q8_calib=h)
    return _kernel_vs_twin(family, (h, tw, ny, nx, height, width, False),
                           canvas)


def cuda_one_sign(ny, nx, core_rows, height, width, family, mode,
                  canvas=False):
    """As :func:`cuda_kernel_vs_twin` (u8 RGB, or the canvas) on
    ops/tail.py's one-sign inputs: the seeded tail of `family` through
    one_sign_up1_, h from one_sign_h, the int8 scales (w8a8, qh8)
    calibrated on that h."""
    gen = torch.Generator().manual_seed(core_rows * 1000 + width)
    tail = ttail.one_sign_up1_(_seeded_tail(family, gen))
    cin, prepare = _FAMILIES[family][1:3]
    h = ttail.one_sign_h((ny * nx, core_rows + 4, ttail.T, cin), gen, "cuda")
    tw = prepare(tail.to("cuda"), q8_calib=h, qh8=mode == "qh8")
    if tw.qh8:
        h = ttail.quantize_h(h, tw)
    return _kernel_vs_twin(family, (h, tw, ny, nx, height, width, False),
                           canvas)


def cuda_tail_params():
    """What each tail kernel reports of itself (ops/tail.py::kernel_params)
    beside the Python side's values: {family: {"modes": {mode: (margin,
    its tensor-core part, geometry)}, "up1_err": ops/tail.py::up1_err(9 x
    channels)}, "block": ops/tail.py::BLOCK, "chunk": CHUNK}."""
    out = {"block": tuple(ttail.BLOCK), "chunk": ttail.CHUNK}
    for family, entry in (("fsrgan", "dgt_tail_params"),
                          ("srgan", "dgt_tail64_params")):
        cin = _FAMILIES[family][1]
        out[family] = {
            "modes": {m: ttail.kernel_params(entry, m) for m in ttail.MODES},
            "up1_err": ttail.up1_err(9 * cin)}
    return out


@torch.no_grad()
def cuda_up1_certain_sound(q8, n=1 << 18, seed=0):
    """ops/tail.py::up1_certain (the kernels' test) on seeded (z, a, xerr,
    wn) against the rounding it vouches for: u1 = prelu(z', a) in f32, then
    q(u1 * inv) (q8, inv = 20) or bf16, at z' = z - d, z, z + d and 0 where
    [z - d, z + d] holds it, d = xerr * wn in float64 (prelu is monotone
    on each side of 0).  Returns (values certain, values uncertain, certain
    values whose points round apart)."""
    gen = torch.Generator().manual_seed(seed)
    inv = 20.0
    z = torch.randn(n, generator=gen, dtype=torch.float64) * 3
    a = torch.rand(n, generator=gen, dtype=torch.float64) * 3 - 1.5
    rel = 10 ** (torch.rand(n, generator=gen, dtype=torch.float64) * 4 - 6)
    wn = torch.rand(n, generator=gen, dtype=torch.float64) * 1.5 + 0.5
    d = (z.abs() + 1 / inv) * rel
    xerr = d / wn
    z32, a32 = z.float(), a.float()
    sure = ttail.up1_certain(*(t.float().cuda() for t in (z, a, xerr, wn)),
                             inv, q8).cpu()

    def rounded(zp):
        v = torch.where(zp >= 0, zp, a32 * zp)
        return torch.round(v * inv) if q8 else v.bfloat16().float()

    lo, hi = (z - d).float(), (z + d).float()
    mid = torch.where((lo <= 0) & (hi >= 0), torch.zeros_like(z32), z32)
    want = rounded(z32)
    apart = torch.zeros(n, dtype=torch.bool)
    for zp in (lo, hi, mid):
        apart |= rounded(zp) != want
    return (int(sure.sum()), int((~sure).sum()), int((sure & apart).sum()))


def _kernel_vs_twin(family, args, canvas):
    """The kernel of `family` (u8, or the canvas epilogue) and its twin on
    the same arguments (h, tw, ny, nx, height, width, bgr) on the card; the
    dict of cuda_kernel_vs_twin."""
    fam = _FAMILIES[family]
    counts = fam[5]
    kernel, twin_fn = (fam[6], fam[7]) if canvas else (fam[3], fam[4])
    mode = args[1].mode
    key = f"{kernel.__name__}:{mode}"
    before = counts[key]
    got = kernel(*args)
    torch.cuda.synchronize()
    launches = counts[key] - before
    want = twin_fn(*args)
    d = (got.float() - want.float()).abs()
    scale = (got.float() + 1) * 127.5 if canvas else got.float()
    return dict(shape=tuple(got.shape), want_shape=tuple(want.shape),
                dtype=str(got.dtype), device=got.device.type,
                launches=launches, max_diff=float(d.max()),
                frac_diff=float((d > 0).float().mean()),
                std_min=float(scale.std(dim=(0, 1)).min()))


def _seeded_block(gen, expand, device):
    """MBConvWeights in bf16 on `device` from a torch.Generator, with
    be in [0.2, 0.5] so that relu(be) > 0 on the ring."""
    e = 192 if expand else 32
    w = {"wd": torch.randn((3, 3, e), generator=gen) / 3,
         "bd": torch.randn(e, generator=gen) * 0.1,
         "wp": torch.randn((e, 32), generator=gen) / e ** 0.5,
         "bp": torch.randn(32, generator=gen) * 0.1}
    if expand:
        w["we"] = torch.randn((32, e), generator=gen) / 32 ** 0.5
        w["be"] = torch.rand(e, generator=gen) * 0.3 + 0.2
    return _mbconv_weights({k: v.numpy() for k, v in w.items()}, "bf16",
                           device=device)


def cuda_mbconv_vs_reference(n, h, w, expand, one_sign=False):
    """The K3 kernel and its plain version on one seeded bf16 x on the card
    (or the one-sign input: ops/mbconv.py::one_sign_x, the block through
    one_sign_block): a dict of the output's shape, dtype and device, the
    kernel's launch-count increment, the max |difference| and the share of
    outputs that differ."""
    gen = torch.Generator().manual_seed(n * 10000 + h * 100 + w)
    if one_sign:
        x = tmbconv.one_sign_x((n, h, w, 32), gen, "cuda")
        mw = tmbconv.one_sign_block(_seeded_block(gen, expand, "cuda"), x)
    else:
        x = (torch.randn((n, h, w, 32), generator=gen) * 0.5).to(
            "cuda", torch.bfloat16)
        mw = _seeded_block(gen, expand, "cuda")
    before = tmbconv.launch_counts["fused_mbconv"]
    got = tmbconv.fused_mbconv(x, mw)
    torch.cuda.synchronize()
    launches = tmbconv.launch_counts["fused_mbconv"] - before
    want = tmbconv.fused_mbconv_reference(x, mw)
    d = (got.float() - want.float()).abs()
    return dict(shape=tuple(got.shape), dtype=str(got.dtype),
                device=got.device.type, launches=launches,
                max_diff=float(d.max()), frac_diff=float((d > 0).float().mean()))


def cuda_mbconv_params():
    """(What the built K3 kernel reports of itself, what ops/mbconv.py
    holds): its margin parts and its geometry."""
    return tmbconv.kernel_params(), (
        tmbconv.margin_parts(),
        (*tmbconv.BLOCK, tmbconv.E_CHUNK, tmbconv.THREADS))


def cuda_mbconv_units(n, h, w):
    """(K3's work units for x (n, h, w, 32), its persistent grid on this
    card: SMs times resident blocks an SM)."""
    bh, bw = tmbconv.BLOCK
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n * -(-h // bh) * -(-w // bw), sms * tmbconv.occupancy(True)[1]


def cuda_mbconv_bad_input(bad):
    """The K3 wrapper on a CUDA x that it does not take: f32, or a
    non-contiguous bf16 view; raises."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, 16, 32), generator=gen).to("cuda")
    if bad == "layout":
        x = x.bfloat16().transpose(1, 2).contiguous().transpose(1, 2)
    tmbconv.fused_mbconv(x, _seeded_block(gen, True, "cuda"))


def default_generator_device():
    """The device type of build_generator("fsrgan") with no device."""
    return build_generator("fsrgan").body.Conv_0.weight.device.type


# ---------------------------------------------------------------------------
# probes/fma_peak.py (K9) and probes/int8_chain.py (K6)

PROBE_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}


def probe_fma_reference(x, iters):
    return _np(tfma.fma_chain_reference(torch.from_numpy(x), iters))


def probe_roll_fma_reference(x, iters):
    return _np(tfma.roll_fma_chain_reference(torch.from_numpy(x), iters))


def probe_fma_f32(a, c, b):
    """fma_peak.fma_f32 on float32 arrays a, b and a float32 value c."""
    return _np(tfma.fma_f32(torch.from_numpy(a), float(c),
                            torch.from_numpy(b)))


def probe_initial_state(k, dtype):
    """(y, w) of int8_chain.initial_state on the CPU, as numpy."""
    return tuple(_np(t) for t in tdot.initial_state(
        k, PROBE_DTYPES[dtype], device="cpu"))


def probe_dot_chain(k, iters, dtype):
    """int8_chain.dot_chain on the CPU (its wrapper runs the plain version
    there): the final y as numpy (bf16 as f32)."""
    return _np(tdot.dot_chain(k, iters, PROBE_DTYPES[dtype], device="cpu"))


def probe_wrappers_on_cpu():
    """Each probe wrapper on CPU tensors against its plain version: whether
    they are equal, and the kernels' launch counts it added."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 256), generator=gen) * 1e-3
    before = {**tfma.launch_counts, **tdot.launch_counts}
    y, w = tdot.initial_state(128, torch.int8, m=40, device="cpu")
    equal = {
        "fma_chain": torch.equal(tfma.fma_chain(x, 20),
                                 tfma.fma_chain_reference(x, 20)),
        "roll_fma_chain": torch.equal(tfma.roll_fma_chain(x, 10),
                                      tfma.roll_fma_chain_reference(x, 10)),
        "dot_chain_steps": torch.equal(
            tdot.dot_chain_steps(y, w, 3),
            tdot.dot_chain_steps_reference(y, w, 3))}
    after = {**tfma.launch_counts, **tdot.launch_counts}
    return equal, {k: after[k] - before[k] for k in after}


def probe_entry_points_without_gpu():
    """The probes' card entry points where torch.cuda.is_available() is
    False: the exception type each raised, or None."""
    calls = {"fma_peak.main": tfma.main, "int8_chain.main": tdot.main,
             "fma_peak.measure": tfma.measure,
             "dot_chain": lambda: tdot.dot_chain(128, 1, torch.int8)}
    raised = {}
    with _no_cuda():
        for name, fn in calls.items():
            try:
                fn()
                raised[name] = None
            except Exception as e:  # noqa: BLE001 - reported to the test
                raised[name] = type(e).__name__
    return raised


def probe_dot_chain_bad_input(bad, device="cpu"):
    """dot_chain_steps on input it does not take: float32, w of the wrong
    shape, K < 128, or (on the card) K not a multiple of the kernel's
    128-byte chunk, or a bf16 K whose slab and ring of w chunks exceed a
    block's shared memory; raises."""
    y, w = tdot.initial_state(2560 if bad == "deep" else 256,
                              torch.bfloat16 if bad == "deep" else torch.int8,
                              m=40, device=device)
    if bad == "dtype":
        y, w = y.float(), w.float()
    elif bad == "w_shape":
        w = w[:, :64]
    elif bad == "short_k":
        y, w = y[:96], w[:96]
    elif bad == "chunk":
        y, w = y[:192].contiguous(), w[:192].contiguous()
    tdot.dot_chain_steps(y, w, 1)


def cuda_probe_fma(shape, iters):
    """K9's FMA kernel and its plain version on one seeded x on the card:
    the launch-count increment, whether they are equal, max |difference|
    and max |plain|."""
    x = (torch.randn(shape, generator=torch.Generator().manual_seed(
        iters)) * 1e-3).to("cuda")
    before = tfma.launch_counts["fma_chain"]
    got = tfma.fma_chain(x, iters)
    torch.cuda.synchronize()
    launches = tfma.launch_counts["fma_chain"] - before
    want = tfma.fma_chain_reference(x, iters)
    return dict(shape=tuple(got.shape), launches=launches,
                equal=torch.equal(got, want),
                max_diff=float((got - want).abs().max()),
                max_abs=float(want.abs().max()))


def cuda_probe_roll(rows, width, iters):
    """K9's roll + FMA kernel and its plain version on one seeded x on the
    card, as cuda_probe_fma."""
    x = (torch.randn((rows, width), generator=torch.Generator().manual_seed(
        rows * width)) * 1e-3).to("cuda")
    before = tfma.launch_counts["roll_fma_chain"]
    got = tfma.roll_fma_chain(x, iters)
    torch.cuda.synchronize()
    launches = tfma.launch_counts["roll_fma_chain"] - before
    want = tfma.roll_fma_chain_reference(x, iters)
    return dict(shape=tuple(got.shape), launches=launches,
                equal=torch.equal(got, want),
                max_diff=float((got - want).abs().max()),
                max_abs=float(want.abs().max()))


def cuda_probe_roll_bad_width(width):
    """The roll kernel's wrapper on a CUDA x of a width it does not take;
    raises."""
    tfma.roll_fma_chain(torch.zeros((2, width), device="cuda"), 1)


def cuda_probe_dot_chain(k, m, iters, dtype, state="probe"):
    """K6's kernel and its plain version on the card from the probe's
    initial state (or int8_chain.random_state) at (k, m): int8 after `iters`
    chained steps; bf16 step by step from the kernel's own previous state,
    each step held to int8_chain.bf16_step_bound, and the kernel's
    `iters`-step launch against its steps.  A dict of the launch-count
    increment, the max |difference|, whether they are equal, the largest
    ratio of a difference to its bound (bf16), whether the one launch
    equals the steps (bf16), and whether rows >= 128 kept their values."""
    dt = PROBE_DTYPES[dtype]
    y, w = (tdot.initial_state(k, dt, m=m, device="cuda") if state == "probe"
            else tdot.random_state(k, dt, m=m, device="cuda"))
    key = f"dot_chain_steps:{dtype}"
    before = tdot.launch_counts[key]
    ratio, one_launch = 0.0, True
    if dt == torch.int8:
        got = tdot.dot_chain_steps(y, w, iters)
        want = tdot.dot_chain_steps_reference(y, w, iters)
    else:
        got = y
        for _ in range(iters):
            prev = got
            got = tdot.dot_chain_steps(prev, w, 1)
            want = tdot.dot_chain_steps_reference(prev, w, 1)
            d = (got[:128].double() - want[:128].double()).abs()
            bound = tdot.bf16_step_bound(prev, w, want).clamp_min(1e-300)
            ratio = max(ratio, float((d / bound).max()))
        one_launch = torch.equal(tdot.dot_chain_steps(y, w, iters), got)
    torch.cuda.synchronize()
    d = (got.double() - want.double()).abs()
    return dict(launches=tdot.launch_counts[key] - before,
                shape=tuple(got.shape), max_diff=float(d.max()),
                equal=torch.equal(got, want), bound_ratio=ratio,
                one_launch=one_launch,
                rest_kept=torch.equal(got[128:], y[128:]))


# ---------------------------------------------------------------------------
# probes/relayout.py (K8) and probes/u8_store.py (K10)

def probe_matmul_form(x, w, form, reps):
    """relayout.matmul_form on the CPU (its wrapper runs the plain version
    there) from f32 arrays of bf16 values: (acc, y) as a float and numpy."""
    acc, y = trel.matmul_form(_bf16(x), _bf16(w), form, reps)
    return float(acc), _np(y)


def probe_transpose_chain(x, iters):
    return _np(trel.transpose_chain(torch.from_numpy(x), iters))


def probe_u8_store(res):
    return _np(tu8.u8_phase_store(torch.from_numpy(res)))


def probe_relayout_wrappers_on_cpu():
    """The K8 and K10 wrappers on CPU tensors against their plain versions:
    whether they are equal, and the kernels' launch counts they added."""
    before = {**trel.launch_counts, **tu8.launch_counts}
    equal = {}
    for form in trel.FORMS:
        x, w = trel.seeded_operands(40, 128, 24, form, "cpu")
        got, want = trel.matmul_form(x, w, form, 5), \
            trel.matmul_form_reference(x, w, form, 5)
        equal[f"matmul_form:{form}"] = all(map(torch.equal, got, want))
    x = trel.seeded_block("cpu", (40, 24))
    equal["transpose_chain"] = torch.equal(
        trel.transpose_chain(x, 3), trel.transpose_chain_reference(x, 3))
    res = tu8.seeded_input("cpu", 256)
    equal["u8_phase_store"] = torch.equal(
        tu8.u8_phase_store(res), tu8.u8_phase_store_reference(res))
    after = {**trel.launch_counts, **tu8.launch_counts}
    return equal, {k: after[k] - before[k] for k in after}


def probe_relayout_entry_points_without_gpu():
    """The K8 and K10 card entry points where torch.cuda.is_available() is
    False: the exception type each raised, or None."""
    calls = {"relayout.main": trel.main, "relayout.measure": trel.measure,
             "u8_store.main": tu8.main, "u8_store.measure": tu8.measure,
             "u8_store.frame_input": tu8.frame_input}
    raised = {}
    with _no_cuda():
        for name, fn in calls.items():
            try:
                fn()
                raised[name] = None
            except Exception as e:  # noqa: BLE001 - reported to the test
                raised[name] = type(e).__name__
    return raised


def probe_relayout_bad_input(bad, device="cpu"):
    """A K8 or K10 wrapper on input it does not take; raises.  K8: f32
    operands, a form it does not know, x of the wrong shape, reps 0, and
    on the card K not a multiple of 64 or above 1152 (the launch fails).
    K10: 47 columns, M not a multiple of 128, bf16 res."""
    form = "sublane" if bad == "x_shape" else "canonical"
    k = {"k_step": 96, "k_max": 1216}.get(bad, 128)
    x, w = trel.seeded_operands(40, k, 24, form, device)
    if bad == "dtype":
        x, w = x.float(), w.float()
    elif bad == "x_shape":
        x = x[:, :-1].contiguous().t().contiguous()
    if bad in ("dtype", "form", "x_shape", "reps", "k_step", "k_max"):
        trel.matmul_form(x, w, "rows" if bad == "form" else form,
                         0 if bad == "reps" else 1)
        return
    res = tu8.seeded_input(device, 256)
    if bad == "u8_cols":
        res = res[:, :47].contiguous()
    elif bad == "u8_rows":
        res = res[:200].contiguous()
    elif bad == "u8_dtype":
        res = res.bfloat16()
    tu8.u8_phase_store(res)


def cuda_probe_matmul_form(m, k, n, form, reps):
    """K8's product kernel and its plain version on the probe's seeded
    operands on the card: the launch-count increment, y's shape, the
    largest ratio of |dy| to relayout.product_bound and of |dacc| to
    relayout.acc_bound, and whether y equals the plain version's."""
    x, w = trel.seeded_operands(m, k, n, form, "cuda",
                                np.random.default_rng(m * k + n))
    key = f"matmul_form:{form}"
    before = trel.launch_counts[key]
    acc, y = trel.matmul_form(x, w, form, reps)
    torch.cuda.synchronize()
    launches = trel.launch_counts[key] - before
    want_acc, want = trel.matmul_form_reference(x, w, form, reps)
    yb = trel.product_bound(x, w, form)
    d = (y.double() - want.double()).abs()
    return dict(launches=launches, shape=tuple(y.shape),
                y_ratio=float((d / yb.clamp_min(1e-300)).max()),
                acc_ratio=abs(float(acc) - float(want_acc))
                / trel.acc_bound(yb, want_acc, reps),
                equal=torch.equal(y, want))


def cuda_probe_transpose_chain(rows, cols, iters):
    """K8's transpose-chain kernel and its plain version on one seeded x on
    the card: the launch-count increment, the shape, whether they are
    equal."""
    x = trel.seeded_block("cuda", (rows, cols))
    before = trel.launch_counts["transpose_chain"]
    got = trel.transpose_chain(x, iters)
    torch.cuda.synchronize()
    launches = trel.launch_counts["transpose_chain"] - before
    want = trel.transpose_chain_reference(x, iters)
    return dict(launches=launches, shape=tuple(got.shape),
                equal=torch.equal(got, want),
                max_diff=float((got - want).abs().max()))


def cuda_probe_u8_store(m):
    """K10's kernel and its plain version on one seeded res (m, 48) on the
    card: the launch-count increment, shape, dtype, whether they are
    equal, max |difference| and the share of bytes that differ."""
    res = tu8.seeded_input("cuda", m, seed=m)
    before = tu8.launch_counts["u8_phase_store"]
    got = tu8.u8_phase_store(res)
    torch.cuda.synchronize()
    launches = tu8.launch_counts["u8_phase_store"] - before
    want = tu8.u8_phase_store_reference(res)
    d = (got.int() - want.int()).abs()
    return dict(launches=launches, shape=tuple(got.shape),
                dtype=str(got.dtype), equal=torch.equal(got, want),
                max_diff=int(d.max()), frac_diff=float((d > 0).float().mean()))


# ---------------------------------------------------------------------------
# probes/overlap.py (K7) and probes/dw_forms.py (K4)

@contextlib.contextmanager
def _one_thread():
    """torch's CPU ops on one thread inside the block: the plain versions'
    many small elementwise ops run far slower on several threads when the
    test workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def probe_overlap_initial_state():
    """(y, z, w) of overlap.initial_state on the CPU, as numpy (bf16 as
    f32)."""
    return tuple(_np(t) for t in tov.initial_state("cpu"))


def probe_overlap_chain(y, z, w, mxu_iters, vpu_iters):
    """overlap.overlap_chain on the CPU (its wrapper runs the plain version
    there) from numpy y and w holding bf16 values: (y, z, o) as numpy."""
    with _one_thread():
        return tuple(_np(t) for t in tov.overlap_chain(
            _bf16(y), torch.from_numpy(z), _bf16(w), mxu_iters, vpu_iters))


def probe_loop_counts(sass):
    return tov.loop_counts(sass)


def probe_dw_initial_state(nch=tdw.NCH):
    return tuple(_np(t) for t in tdw.initial_state("cpu", nch))


def probe_dw_chain(e, w, reps, form):
    """dw_forms.dw_chain on the CPU (the plain version): (e, d) as numpy."""
    with _one_thread():
        return tuple(_np(t) for t in tdw.dw_chain(
            torch.from_numpy(e), torch.from_numpy(w), reps, form))


def probe_overlap_dw_wrappers_on_cpu():
    """The K7 and K4 wrappers on CPU tensors against their plain versions,
    at a narrow y and z and a few channels: whether they are equal, and the
    kernels' launch counts they added."""
    with _one_thread():
        return _overlap_dw_wrappers_on_cpu()


def _overlap_dw_wrappers_on_cpu():
    before = {**tov.launch_counts, **tdw.launch_counts}
    y, z, w = tov.initial_state("cpu")
    y, z = y[:, :384].contiguous(), z[:, :384].contiguous()
    equal = {}
    for mi, vi in ((3, 0), (0, 3), (3, 2)):
        got = tov.overlap_chain(y, z, w, mi, vi)
        want = tov.overlap_chain_reference(y, z, w, mi, vi)
        equal[f"overlap_chain:{tov.mode(mi, vi)}"] = all(
            map(torch.equal, got, want))
    e, w4 = tdw.initial_state("cpu", 5)
    for form in tdw.FORMS:
        got, want = tdw.dw_chain(e, w4, 2, form), \
            tdw.dw_chain_reference(e, w4, 2, form)
        equal[f"dw_chain:{form}"] = all(map(torch.equal, got, want))
    after = {**tov.launch_counts, **tdw.launch_counts}
    return equal, {k: after[k] - before[k] for k in after}


def probe_overlap_dw_entry_points_without_gpu():
    """The K7 and K4 card entry points where torch.cuda.is_available() is
    False: the exception type each raised, or None."""
    calls = {"overlap.main": tov.main, "overlap.measure": tov.measure,
             "overlap.initial_state": tov.initial_state,
             "dw_forms.main": tdw.main, "dw_forms.measure": tdw.measure,
             "dw_forms.library_ms": tdw.library_ms,
             "dw_forms.initial_state": tdw.initial_state}
    raised = {}
    with _no_cuda():
        for name, fn in calls.items():
            try:
                fn()
                raised[name] = None
            except Exception as e:  # noqa: BLE001 - reported to the test
                raised[name] = type(e).__name__
    return raised


def probe_overlap_bad_input(bad, device="cpu"):
    """overlap_chain on input it does not take; raises.  Everywhere: f32 y,
    z of the wrong shape, w of the wrong shape, a negative count; on the
    card also a width other than 15360, a non-contiguous z and w on the
    CPU."""
    y, z, w = tov.initial_state(device)
    if bad == "dtype":
        y = y.float()
    elif bad == "z_shape":
        z = z[:4]
    elif bad == "w_shape":
        w = w[:, :64]
    elif bad == "width":
        y, z = y[:, :256].contiguous(), z[:, :256].contiguous()
    elif bad == "contiguous":
        z = z.t().contiguous().t()
    elif bad == "device":
        w = w.cpu()
    tov.overlap_chain(y, z, w, -1 if bad == "iters" else 2, 1)


def probe_dw_bad_input(bad, device="cpu"):
    """dw_chain on input it does not take; raises: f64 e, a form it does
    not know, a band narrower than 2176, w of the wrong shape, reps 0, and
    on the card a non-contiguous w and w on the CPU."""
    e, w = tdw.initial_state(device, 3)
    form = "rows" if bad == "form" else "value"
    if bad == "dtype":
        e = e.double()
    elif bad == "width":
        e = e[:, :2048].contiguous()
    elif bad == "w_shape":
        w = w[:, :2]
    elif bad == "contiguous":
        w = w.t().contiguous().t()
    elif bad == "device":
        w = w.cpu()
    tdw.dw_chain(e, w, 0 if bad == "reps" else 1, form)


def cuda_probe_overlap_full(mxu_iters, vpu_iters):
    """K7's kernel and its plain version on the card from the initial state
    at the given counts: the launch-count increment, whether z is
    bit-identical, whether y's columns 128.. kept their values (and all of
    y where the product does not run), and the share of y[:, 0:128] that
    is NaN on each side."""
    y, z, w = tov.initial_state("cuda")
    key = f"overlap_chain:{tov.mode(mxu_iters, vpu_iters)}"
    before = tov.launch_counts[key]
    gy, gz, _ = tov.overlap_chain(y, z, w, mxu_iters, vpu_iters)
    torch.cuda.synchronize()
    launches = tov.launch_counts[key] - before
    wy, wz, _ = tov.overlap_chain_reference(y, z, w, mxu_iters, vpu_iters)
    return dict(launches=launches, z_equal=torch.equal(gz, wz),
                kept=torch.equal(gy[:, tov.ROWS:], y[:, tov.ROWS:])
                and (bool(mxu_iters) or torch.equal(gy, y)),
                nan=float(torch.isnan(gy[:, :tov.ROWS].float()).float()
                          .mean()),
                plain_nan=float(torch.isnan(wy[:, :tov.ROWS].float())
                                .float().mean()))


def cuda_probe_overlap_steps(mxu_iters, vpu_iters, steps):
    """K7 on the card, step by step from the initial state: each kernel
    step of (mxu_iters, vpu_iters) (0 or 1 each) from the kernel's previous
    state against the plain version's step from the same state: the
    largest ratio of y's difference to overlap.step_bound, whether z was
    equal and y's columns 128.. kept at every step, and whether one launch
    of the steps equals them."""
    y0, z0, w = tov.initial_state("cuda")
    y, z, ratio, equal = y0, z0, 0.0, True
    for _ in range(steps):
        gy, gz, _ = tov.overlap_chain(y, z, w, mxu_iters, vpu_iters)
        torch.cuda.synchronize()
        wy, wz, _ = tov.overlap_chain_reference(y, z, w, mxu_iters,
                                                vpu_iters)
        d = (gy[:, :tov.ROWS].double() - wy[:, :tov.ROWS].double()).abs()
        ratio = max(ratio, float((d / tov.step_bound(y, w, wy)
                                  .clamp_min(1e-300)).max()))
        equal &= torch.equal(gz, wz) and \
            torch.equal(gy[:, tov.ROWS:], y0[:, tov.ROWS:])
        y, z = gy, gz
    one = tov.overlap_chain(y0, z0, w, steps * mxu_iters, steps * vpu_iters)
    return dict(ratio=ratio, equal=equal,
                one_launch=torch.equal(one[0], y) and torch.equal(one[1], z),
                finite=bool(torch.isfinite(y.float()).all()))


def cuda_probe_dw(nch, reps, form):
    """K4's kernel of one form and its plain version on the card from the
    initial state at nch channels: the launch-count increment, shapes, and
    whether e and d are bit-identical."""
    e, w = tdw.initial_state("cuda", nch)
    key = f"dw_chain:{form}"
    before = tdw.launch_counts[key]
    ge, gd = tdw.dw_chain(e, w, reps, form)
    torch.cuda.synchronize()
    launches = tdw.launch_counts[key] - before
    we, wd = tdw.dw_chain_reference(e, w, reps, form)
    return dict(launches=launches, shapes=(tuple(ge.shape), tuple(gd.shape)),
                equal=torch.equal(ge, we) and torch.equal(gd, wd),
                max_diff=float((gd - wd).abs().max()))


# ---------------------------------------------------------------------------
# probes/mbpipe.py (K5)

def _mb_state(r1, r2, we, wp, wdw):
    return (_bf16(r1), _bf16(r2), _bf16(we), _bf16(wp), torch.from_numpy(wdw))


def probe_mbpipe_initial_state():
    """mbpipe.initial_state on the CPU, as numpy (bf16 as f32)."""
    return tuple(_np(t) for t in tmb.initial_state("cpu"))


def probe_mbpipe_chain(r1, r2, we, wp, wdw, reps, chains):
    """mbpipe.mbpipe_chain on the CPU (its wrapper runs the plain version
    there) from numpy arrays holding bf16 values (wdw f32): (r1, r2, e, d,
    p) as numpy."""
    with _one_thread():
        return tuple(_np(t) for t in tmb.mbpipe_chain(
            _mb_state(r1, r2, we, wp, wdw), reps, chains))


def probe_mbpipe_wrapper_on_cpu():
    """The K5 wrapper on CPU tensors against its plain version in every
    mode, on the probe's state and on a seeded state of two bands:
    whether they are equal, and the kernel's launch counts they added."""
    with _one_thread():
        before = dict(tmb.launch_counts)
        equal = {}
        for name, state in (("probe", tmb.initial_state("cpu")),
                            ("seeded", tmb.seeded_state(0, 2, "cpu"))):
            for chains, sync in tmb.MODES:
                got = tmb.mbpipe_chain(state, 1, chains, sync)
                want = tmb.mbpipe_chain_reference(state, 1, chains)
                equal[f"{name}:{tmb.mode_key(chains, sync)}"] = all(
                    map(torch.equal, got, want))
        return equal, {k: tmb.launch_counts[k] - before[k]
                       for k in before}


def probe_mbpipe_seeded_bands(chains):
    """The plain version on a seeded state of three bands against each
    band alone: whether every output agrees, and the share of each
    chain's window that moved (so chain 2 is no fixed point there)."""
    with _one_thread():
        state = tmb.seeded_state(1, 3, "cpu")
        r1, r2, *w = state
        banded = tmb.mbpipe_chain_reference(state, 1, chains)
        same = True
        for b in range(3):
            one = tmb.mbpipe_chain_reference((r1[b], r2[b], *w), 1, chains)
            same &= all(torch.equal(x[b], y) for x, y in zip(banded, one))
        win = slice(tmb.CHUNK, tmb.CHUNK + tmb.MP)
        moved = [float((banded[q][..., win] != state[q][..., win]).float()
                       .mean()) for q in range(2)]
        return same, moved


def probe_mbpipe_entry_points_without_gpu():
    """The K5 card entry points where torch.cuda.is_available() is False:
    the exception type each raised, or None."""
    calls = {"mbpipe.main": tmb.main, "mbpipe.measure": tmb.measure,
             "mbpipe.clocks": tmb.clocks,
             "mbpipe.yardstick_ms": tmb.yardstick_ms,
             "mbpipe.initial_state": tmb.initial_state,
             "mbpipe.seeded_state": lambda: tmb.seeded_state(0),
             "mbpipe.check": lambda: tmb.check(tmb.initial_state("cpu"), 1,
                                               1)}
    raised = {}
    with _no_cuda():
        for name, fn in calls.items():
            try:
                fn()
                raised[name] = None
            except Exception as e:  # noqa: BLE001 - reported to the test
                raised[name] = type(e).__name__
    return raised


def probe_mbpipe_bad_input(bad, device="cpu"):
    """mbpipe_chain on input it does not take; raises.  Everywhere: f32
    r1, r2 narrower than 2176, wp of the wrong shape, f64 wdw, 3 chains,
    reps 0, r1 with a band axis and r2 without; on the card also a
    non-contiguous we and wdw on the CPU; one chain with a sync of two."""
    state = list(tmb.initial_state(device))
    reps, chains, sync = 1, 2, "own"
    if bad == "dtype":
        state[0] = state[0].float()
    elif bad == "r_shape":
        state[1] = state[1][:, :2048]
    elif bad == "w_shape":
        state[3] = state[3][:, :16]
    elif bad == "wdw_dtype":
        state[4] = state[4].double()
    elif bad == "chains":
        chains = 3
    elif bad == "reps":
        reps = 0
    elif bad == "sync":
        chains, sync = 1, "offset"
    elif bad == "bands":
        state[0] = state[0][None]
    elif bad == "contiguous":
        state[2] = state[2].t().contiguous().t()
    elif bad == "device":
        state[4] = state[4].cpu()
    tmb.mbpipe_chain(tuple(state), reps, chains, sync)


def cuda_probe_mbpipe(reps, chains, sync="own", seed=None, bands=None):
    """K5's kernel in one mode on the card at `reps` steps from the probe's
    initial state (or seeded_state(seed, bands)), held by mbpipe.check."""
    state = tmb.initial_state("cuda") if seed is None else \
        tmb.seeded_state(seed, bands, "cuda")
    return tmb.check(state, reps, chains, sync)


# ---------------------------------------------------------------------------
# the 1x families, infer/tile.py, infer/engine.py's frame engine, infer/fast.py

ACC = {"f32": torch.float32, "bf16": torch.bfloat16}


def generator_1x_forward(family, params, stats, xs, dts):
    """The port's `family` generator loaded from Flax trees, on each input
    of `xs` in each compute dtype of `dts`: {dt: [outputs]}."""
    out = {}
    for dt in dts:
        model = from_jax_params(build_generator(
            family, dtype=DTYPES[dt], device="cpu"), params, stats)
        with torch.no_grad():
            out[dt] = [_np(model(torch.from_numpy(x))) for x in xs]
    return out


class _Scope(torch.nn.Module):
    """One layer under a Flax-like scope name, for from_jax_params."""

    def __init__(self, name, layer):
        super().__init__()
        setattr(self, name, layer)
        self.name = name

    def forward(self, x):
        nchw = getattr(self, self.name)(torch.from_numpy(x).permute(
            0, 3, 1, 2))
        return _np(nchw.permute(0, 2, 3, 1))


def layer_forward(kind, x, kernel=None, bias=None, stride=1):
    """`kind` "conv" (Conv, SAME at `stride`), "conv_transpose"
    (ConvTranspose, 4x4 stride 2 SAME), each loaded from its Flax kernel
    and bias through from_jax_params, or "max_pool" (max_pool_same), on
    NHWC x."""
    if kind == "max_pool":
        return _np(tlayers.max_pool_same(torch.from_numpy(x).permute(
            0, 3, 1, 2)).permute(0, 2, 3, 1))
    kh, _, cin, cout = kernel.shape
    if kind == "conv":
        scope = _Scope("Conv_0", tlayers.Conv(cin, cout, kh, stride=stride))
    else:
        scope = _Scope("ConvTranspose_0", tlayers.ConvTranspose(
            cin, cout, kh, stride))
    from_jax_params(scope, {scope.name: {"kernel": kernel, "bias": bias}})
    with torch.no_grad():
        return scope(x)


def tile_plans(cases):
    """plan_tiles and _feather for each (h, w, tile, overlap, scale)."""
    return [(ttile.plan_tiles(h, w, t, o), ttile._feather(t, s, o))
            for h, w, t, o, s in cases]


def _pattern_fn(scale, pattern, seen):
    """The tests' per-tile function: nearest upsampling by `scale`, halved,
    plus a fixed (T*scale, T*scale, C) pattern, so each output pixel
    depends on its place in the tile; records the batch sizes it sees."""
    p = torch.from_numpy(pattern)

    def fn(tiles):
        seen.append(int(tiles.shape[0]))
        up = tiles.repeat_interleave(scale, 1).repeat_interleave(scale, 2)
        return up * 0.5 + p
    return fn


def tiled_apply_case(img, tile, overlap, scale, batch, pattern):
    """tiled_apply of the pattern function on img: (output, the batch
    sizes the function saw)."""
    seen = []
    out = ttile.tiled_apply(_pattern_fn(scale, pattern, seen),
                            torch.from_numpy(img), tile, overlap, scale,
                            batch)
    return _np(out), seen


def extract_tiles(img, tile, overlap):
    return _np(ttile.extract_tiles(torch.from_numpy(img), tile, overlap))


def phase_feather(tile, scale, overlap, c):
    return tengine._phase_feather(tile, scale, overlap, c)


def overlap_add(tiles, ny, nx, tile, stride):
    return _np(tengine.overlap_add(torch.from_numpy(tiles), ny, nx, tile,
                                   stride))


def _affine_forward(a, b):
    """The engine tests' forward_coarse: x[..., k % 3] * a[k] + b[:h, :w,
    k] on (N, h, w, 3), to len(a) channels."""
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    idx = torch.arange(a.shape[0]) % 3

    def forward(x):
        h, w = x.shape[1:3]
        return x[..., idx] * a + b[:h, :w]
    return forward


def frame_engine_affine(a, b, frames, height, width, scale, **kw):
    """build_frame_engine of the affine forward (options `kw`, acc_dtype by
    name) on the CPU, on each of `frames` (or on them stacked, with
    frames_per_call > 1)."""
    kw["acc_dtype"] = ACC[kw.get("acc_dtype", "f32")]
    run = tengine.build_frame_engine(_affine_forward(a, b), height, width,
                                     scale, device="cpu", **kw)
    if kw.get("frames_per_call", 1) > 1:
        return _np(run(torch.from_numpy(np.stack(frames))))
    return [_np(run(torch.from_numpy(f))) for f in frames]


def frame_engine_refusals(height, width):
    """The messages of what build_frame_engine and its fn refuse: bgr at
    scale 4; a frame of the wrong shape; one on another device."""
    fwd = _affine_forward(np.ones(3, np.float32),
                          np.zeros((64, 64, 3), np.float32))
    out = []
    for attempt in (
            lambda: tengine.build_frame_engine(fwd, height, width, 4,
                                               16, 4, bgr=True,
                                               device="cpu"),
            lambda: tengine.build_frame_engine(fwd, height, width, 1, 16, 4,
                                               device="cpu")(
                torch.zeros(height + 1, width, 3)),
            lambda: tengine.build_frame_engine(fwd, height, width, 1, 16, 4,
                                               device="cpu")(
                torch.zeros(height, width, 3, device="meta"))):
        try:
            attempt()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def frame_engine_generator(family, params, stats, frames, tile, overlap,
                           stitch, dt="f32", out_uint8=True):
    """The 1x frame engine as the video CLI builds it: the family's plain
    generator (compute dtype `dt`) per tile, scale 1, on the CPU."""
    model = from_jax_params(build_generator(
        family, dtype=DTYPES[dt], device="cpu"), params, stats)
    height, width = frames[0].shape[:2]
    run = tengine.build_frame_engine(model, height, width, 1, tile, overlap,
                                     out_uint8=out_uint8, stitch=stitch,
                                     device="cpu")
    return [_np(run(torch.from_numpy(f))) for f in frames]


def fast_paths(family, scale, params, stats, x):
    """build_fast_coarse (bf16, f32 out) and build_fast_forward (bf16) of
    the port generator on x: (coarse output, its scale, forward output).
    The coarse output is None for a 1x family, whose build_fast_coarse
    raises ValueError (its message is returned in its place)."""
    model = from_jax_params(build_generator(family, device="cpu",
                                            scale=scale), params, stats)
    xt = torch.from_numpy(x)
    try:
        fwd, s = tfast.build_fast_coarse(model)
        coarse = _np(fwd(xt))
    except ValueError as e:
        coarse, s = str(e), None
    return coarse, s, _np(tfast.build_fast_forward(model)(xt))


def scatter_and_perm(w, m, c_next):
    return tfast.scatter_conv_kernel(w, m), tfast.d2s_perm(m, c_next)


def cuda_requests_1x():
    """With CUDA absent: the RuntimeError message of each new CUDA entry
    point (build_generator for each family, SRGAN 2x, build_frame_engine
    at its default device), None where one did not raise."""
    fwd = _affine_forward(np.ones(3, np.float32),
                          np.zeros((64, 64, 3), np.float32))
    attempts = [lambda f=f: build_generator(f)
                for f in ("autoencoder", "pix2pix", "fsrgan", "srgan")]
    attempts += [lambda: build_generator("srgan", scale=2),
                 lambda: tengine.build_frame_engine(fwd, 40, 56, 1, 16, 4)]
    messages = []
    with _no_cuda():
        for attempt in attempts:
            try:
                attempt()
                messages.append(None)
            except RuntimeError as e:
                messages.append(str(e))
    return messages


def cuda_generic_vs_cpu(family, dt):
    """chip_smoke.py's check (a) as a test: `family`'s generic engine
    (chip_smoke.generic_engine, its phase-4e weights) at its cut geometry,
    compute dtype `dt`, on the card and on the CPU, and the f32 engine on
    the CPU.  Returns u8 stats: the card against the CPU in `dt`, the card
    and the CPU in `dt` each against the CPU in f32, and the card output's
    shape (and the one expected), dtype and device."""
    import chip_smoke as cs

    rng = np.random.default_rng(cs.SEED + 1)
    if family in cs.TILES_1X:
        model = build_generator(family, device="cpu")
        model = from_jax_params(model, *cs.seeded_flax_tree(model, rng))
    else:
        model = build_generator(family, device="cpu", scale=2 if
                                family == "srgan" else 4)
        model = from_jax_params(model, *cs.seeded_flax_tree(
            model, rng, *((cs.SRGAN_BODY_GAIN, 1.0) if family == "srgan"
                          else ())))
    height, width = cs.CUT[family]
    frame = cs.seeded_frame(rng, height, width, "cpu")
    card = copy.deepcopy(model).cuda()
    got = cs.generic_engine(family, card, height, width, DTYPES[dt]
                            or torch.float32)(frame.cuda())
    cpu = cs.generic_engine(family, model, height, width, DTYPES[dt]
                            or torch.float32)(frame)
    f32 = cs.generic_engine(family, model, height, width,
                            torch.float32)(frame)

    def stats(a, b):
        d = (a.cpu().int() - b.int()).abs()
        return {"max": int(d.max()), "gt0": float((d > 0).float().mean()),
                "gt1": float((d > 1).float().mean())}
    scale = {"fsrgan": 4, "srgan": 2}.get(family, 1)
    return {"card_cpu": stats(got, cpu), "card_f32": stats(got, f32),
            "cpu_f32": stats(cpu, f32), "shape": tuple(got.shape),
            "want_shape": (height * scale, width * scale, 3),
            "dtype": str(got.dtype), "device": got.device.type}
