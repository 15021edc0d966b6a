"""The PyTorch half of the port tests (tests/test_torch_*.py).

tests/torch_process.py runs these functions in a child process, so that no
pytest worker imports torch.  They take and return numpy arrays and plain
Python values.  bf16 tensors travel as f32 arrays, which hold bf16 values
exactly.  Flax parameter trees arrive as nested dicts of numpy arrays and
reach the port through ``from_jax_params``.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path

import numpy as np
import torch

from denoise_gan_tpu_torch.infer import engine as tengine
from denoise_gan_tpu_torch.infer import kernel_engine as tke
from denoise_gan_tpu_torch.io.params import from_jax_params
from denoise_gan_tpu_torch.models import build_generator
from denoise_gan_tpu_torch.models import fsrgan as tfsrgan
from denoise_gan_tpu_torch.models.layers import BatchNorm
from denoise_gan_tpu_torch.ops import _build
from denoise_gan_tpu_torch.ops import image as timage
from denoise_gan_tpu_torch.ops import tail as ttail
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


def batchnorm_train_forward():
    BatchNorm(4).train()(torch.zeros(1, 4, 2, 2))


def seeded_generators(seed):
    """Two generators built from one seed: (training flag of the first,
    both state dicts as numpy)."""
    a, b = (build_generator("fsrgan",
                            generator=torch.Generator().manual_seed(seed))
            for _ in range(2))
    return (a.training, {k: _np(v) for k, v in a.state_dict().items()},
            {k: _np(v) for k, v in b.state_dict().items()})


def build_family(family):
    build_generator(family)


# ---------------------------------------------------------------------------
# ops/tail.py

def _tail(params):
    return from_jax_params(tfsrgan.FSRGANTail().eval(), params)


def q8_weights(params):
    return ttail.prep_weights_q8(ttail.prep_weights(_tail(params)))


def calibrate(params, h):
    """(calibrate_tail_scales at Q8_MARGIN, Q8_MARGIN)."""
    scales = ttail.calibrate_tail_scales(_tail(params), _bf16(h),
                                         margin=ttail.Q8_MARGIN)
    return scales, ttail.Q8_MARGIN


def twin(params, h, ny, nx, height, width, q8=False, bgr=False):
    """The twin's u8 frame, and whether the weights were w8a8; w8a8
    calibrates on h itself."""
    ht = _bf16(h)
    tw = ttail.prepare_tail(_tail(params), q8_calib=ht if q8 else None)
    out = ttail.fused_tail_u8_reference(ht, tw, ny, nx, height, width, bgr)
    return out.numpy(), tw.q8


def wrapper_on_cpu(params, h, ny, nx, height, width):
    """(wrapper's frame, twin's frame, launch-count increments)."""
    ht = _bf16(h)
    tw = ttail.prepare_tail(_tail(params))
    before = dict(ttail.launch_counts)
    got = ttail.fused_tail_u8(ht, tw, ny, nx, height, width)
    want = ttail.fused_tail_u8_reference(ht, tw, ny, nx, height, width)
    return got.numpy(), want.numpy(), {
        k: ttail.launch_counts[k] - before[k] for k in before}


def wrapper_off_cpu_without_cuda(params, ny, nx, core_rows, height, width):
    """Call the wrapper on a tensor that is not on the CPU, with CUDA
    reading as absent: raises."""
    tw = ttail.prepare_tail(_tail(params), device="meta")
    h = torch.empty((ny * nx, core_rows + 4, ttail.T, 32),
                    dtype=torch.bfloat16, device="meta")
    with _no_cuda():
        ttail.fused_tail_u8(h, tw, ny, nx, height, width)


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


def wrapper_bad_input(params, h, ny, nx, height, width, bad):
    """Call the wrapper with one input spoilt as `bad` names; raises."""
    ht = _bf16(h)
    args = dict(h=ht, tw=ttail.prepare_tail(_tail(params)), ny=ny, nx=nx,
                height=height, width=width)
    if bad == "dtype":
        args["h"] = ht.float()
    elif bad == "width":
        args["h"] = ht[:, :, :120]
    elif bad == "tiles":
        args["nx"] = nx + 1
    elif bad == "frame":
        args["width"] = width + 1
    elif bad == "layout":
        args["h"] = ht.transpose(1, 2).contiguous().transpose(1, 2)
    ttail.fused_tail_u8(**args)


# ---------------------------------------------------------------------------
# infer/kernel_engine.py

def _generator(params, stats):
    return from_jax_params(tfsrgan.FSRGANGenerator().eval(), params, stats)


def engine_frames(params, stats, height, width, brc, frames, calib=None,
                  bgr=False):
    """build_fsrgan_kernel_engine's u8 output for each frame (w8a8 when
    `calib`, the index of the calibration frame, is given), and the
    launch-count increments."""
    q8_frame = None if calib is None else torch.from_numpy(frames[calib])
    run = tke.build_fsrgan_kernel_engine(_generator(params, stats), height,
                                         width, brc=brc,
                                         q8_calib_frame=q8_frame, bgr=bgr)
    before = dict(ttail.launch_counts)
    outs = [run(torch.from_numpy(f)).numpy() for f in frames]
    return outs, {k: ttail.launch_counts[k] - before[k] for k in before}


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
# csrc/tail.cu on the card

_CUDA_TAILS = {}


def cuda_available():
    return torch.cuda.is_available()


def _cuda_tails():
    """bf16 and w8a8 TailWeights of a seeded tail on the card."""
    if not _CUDA_TAILS:
        dev = torch.device("cuda")
        gen = torch.Generator().manual_seed(0)
        tail = tfsrgan.FSRGANTail(generator=gen).eval()
        with torch.no_grad():
            for name, p in tail.named_parameters():
                if name.endswith("alpha"):
                    p.uniform_(0.05, 0.3, generator=gen)
                elif name.endswith("bias"):
                    p.normal_(0.0, 0.05, generator=gen)
        tail = tail.to(dev)
        calib = (torch.randn((4, 28, ttail.T, 32), generator=gen)
                 * 0.5).to(dev, torch.bfloat16)
        _CUDA_TAILS.update(bf16=ttail.prepare_tail(tail),
                           w8a8=ttail.prepare_tail(tail, q8_calib=calib))
    return _CUDA_TAILS


def cuda_kernel_vs_twin(ny, nx, core_rows, height, width, mode, bgr):
    """The kernel and the twin on one seeded h on the card: a dict of the
    kernel's output shape, dtype and device, its launch-count increment,
    max |du8| and the share of bytes that differ, and the kernel output's
    smallest per-channel std."""
    gen = torch.Generator().manual_seed(core_rows * 1000 + width)
    h = (torch.randn((ny * nx, core_rows + 4, ttail.T, 32), generator=gen)
         * 0.5).to("cuda", torch.bfloat16)
    args = (h, _cuda_tails()[mode], ny, nx, height, width, bgr)
    before = ttail.launch_counts["fused_tail_u8"]
    got = ttail.fused_tail_u8(*args)
    torch.cuda.synchronize()
    launches = ttail.launch_counts["fused_tail_u8"] - before
    want = ttail.fused_tail_u8_reference(*args)
    d = (got.int() - want.int()).abs()
    return dict(shape=tuple(got.shape), want_shape=tuple(want.shape),
                dtype=str(got.dtype), device=got.device.type,
                launches=launches, max_diff=int(d.max()),
                frac_diff=float((d > 0).float().mean()),
                std_min=float(got.float().std(dim=(0, 1)).min()))
