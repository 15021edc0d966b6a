#!/usr/bin/env python3
"""Smoke run of the PyTorch port (denoise_gan_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each printed on its own line:
1. device: needs torch.cuda; prints nvidia-smi's name and power limit.
2. build: compiles csrc/*.cu with nvcc into the package's _build/.
3. K1 vs twin: the FSRGAN fused tail kernel (csrc/tail.cu) against its
   plain PyTorch twin at the 1080p main-path shapes (h (128, 139, 124, 32)
   bf16, 8x16 tiles, core_rows 135), bf16 and w8a8, RGB and BGR.  Bound:
   max |du8| <= 1 on < 1e-3 of the bytes; w8a8 must be bit-identical.
3b. K2 vs twin: the SRGAN fused tail kernel (csrc/tail_srgan.cu) the same
   way, at h (128, 139, 124, 64).
3c. K3 vs its plain version: the fused inverted residual (csrc/mbconv.cu)
   at the 1080p body shape x (128, 139, 124, 32) bf16, with and without
   the expand, on the seeded FSRGAN blocks (non-zero BN statistics, so
   relu(be) > 0 and the zero ring of the expanded tensor matters).  Target:
   bit-identical; bound: within 1 bf16 ulp on < 1e-3 of the outputs.
4. FSRGAN engine: the full-width FSRGAN generator (gf=32, 6 blocks) from
   numpy-seeded weights, 1080p -> 4K through build_fsrgan_kernel_engine
   (w8a8, calibrated on the first frame) on two alternating seeded frames.
   Checks shape, dtype, device, that K1 ran once per frame and no other
   tail ran, that the output is not flat, the same engine with the twin
   as tail within the phase-3 bound, and, on a small input, the bf16 kernel
   tail against the plain f32 FSRGANTail module.
4b. SRGAN engine: the full-width SRGAN generator (16 residual blocks, 64
   filters) the same way through build_srgan_kernel_engine, with K2; then
   the input options: the u8_input + bgr_input engine on a uint8 BGR frame
   byte for byte against the bgr_input engine on the same frame as float
   (w8a8), and against the float RGB engine within the whole-slice
   envelopes (bf16 max <= 1 on < 5%; w8a8 max <= 3, > 1 on < 1%).
4c. FSRGAN engine with the K3 body: prepare_mbconv_fsrgan_engine (the
   body's six inverted residuals as K3 launches, the w8a8 tail calibrated
   on its output) wired by build_kernel_engine, on the same frames.  Checks
   that K3 ran 6 times and K1 once per frame and nothing else, the output
   as phase 4, and the engine against the plain-body engine on the same
   weights and tail: both bf16 bodies round away from the f32 body (the K3
   body once per block, the plain one after every op), so the bound is the
   plain-body engine's own distance from the engine with the f32 body (TF32
   off): the K3-body engine differs from that engine on no more bytes, and
   by more than one level on no more bytes.  Then the same engine with K3's
   plain version as its blocks, within the phase-3c bound.
5. times: per engine, frames/s (kernel vs twin tail), tail ms/frame (kernel
   vs twin in both modes, and the bf16 tail module on cuDNN), body
   ms/frame; K3's six launches per frame vs its plain version and the six
   plain InvertedResidual modules on cuDNN, and the K3-body engine's
   frames/s beside the plain-body engine's; each beside the card's name and
   power limit.  Each kernel's bound (the larger of its bytes over 3.35 TB/s
   and its operations over the tensor-core peak for their type) is computed
   from the main path's shapes.

Any failure raises, and the run exits non-zero.  The line before the last
is the kernels' JSON record, the last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from denoise_gan_tpu_torch.infer import kernel_engine as ke
from denoise_gan_tpu_torch.io.params import from_jax_params
from denoise_gan_tpu_torch.models import build_generator
from denoise_gan_tpu_torch.models.fsrgan import FSRGANTail
from denoise_gan_tpu_torch.models.srgan import SRGANTail
from denoise_gan_tpu_torch.ops import _build
from denoise_gan_tpu_torch.ops import mbconv
from denoise_gan_tpu_torch.ops import tail as tail_ops
from denoise_gan_tpu_torch.ops import tail_srgan
from denoise_gan_tpu_torch.utils.device import require_cuda

HEIGHT, WIDTH = 1080, 1920
SEED = 0
MAX_DIFF, MAX_FRAC = 1, 1e-3      # u8 bound, kernel vs twin
STD_FLOOR = 8.0                   # per-channel u8 std of a non-flat frame
MAIN_FRAMES = 4                   # frames driven through each main path
TIMED_FRAMES = 10
# SRGAN residual-block and post-conv kernels at a tenth of LeCun normal, as
# tests/test_torch_engine_srgan.py: 16 residual adds then neither saturate
# tanh nor amplify bf16 rounding differences between two engines' bodies.
SRGAN_BODY_GAIN = 0.1
# H100 SXM peaks (NVIDIA's data sheet, dense): the bounds' rates
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
INT8_OP_S = 1979e12


@dataclass(frozen=True)
class Family:
    """One 4x family's pieces: generator name, tail module class, body
    channels, tail preparation, kernel wrapper, twin, their launch counts,
    engine builder and preparation, the CUDA source, the TPU kernel it
    replaces, and the gains of the seeded body and output conv."""

    name: str
    tail_cls: type
    cin: int
    prepare: Callable
    kernel: Callable
    twin: Callable
    counts: dict
    build: Callable
    prepare_engine: Callable
    source: str
    replaces: str
    body_gain: float
    out_gain: float


FAMILIES = [
    Family("fsrgan", FSRGANTail, 32, tail_ops.prepare_tail,
           tail_ops.fused_tail_u8, tail_ops.fused_tail_u8_reference,
           tail_ops.launch_counts, ke.build_fsrgan_kernel_engine,
           ke.prepare_fsrgan_engine, "denoise_gan_tpu_torch/csrc/tail.cu",
           "denoise_gan_tpu/ops/pallas/tail.py:290", 1.0, 0.5),
    Family("srgan", SRGANTail, 64, tail_srgan.prepare_tail64,
           tail_srgan.fused_tail64_u8, tail_srgan.fused_tail64_u8_reference,
           tail_srgan.launch_counts, ke.build_srgan_kernel_engine,
           ke.prepare_srgan_engine,
           "denoise_gan_tpu_torch/csrc/tail_srgan.cu",
           "denoise_gan_tpu/ops/pallas/tail_srgan.py:151", SRGAN_BODY_GAIN,
           1.0),
]


COUNTS = [f.counts for f in FAMILIES] + [mbconv.launch_counts]


def all_counts() -> dict[str, int]:
    return {k: v for counts in COUNTS for k, v in counts.items()}


def reset_counts() -> None:
    for counts in COUNTS:
        for k in counts:
            counts[k] = 0


def bound(n_bytes: float, ops: list[tuple[float, float]]
          ) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of n_bytes over the memory rate and
    the sum of ops / rate over the (ops, rate) pairs."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = sum(o / r for o, r in ops)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def tail_bound(h: torch.Tensor, tw, cin: int) -> tuple[float, str]:
    """Bound of a w8a8 tail at 1080p: h read once, the 4K frame written
    once; per core coarse pixel, up1 (9C x 4C multiply-adds) in bf16, up2
    (four 2x pixels of 9C x 4C) and the output conv (16 fine pixels of
    k*k*C x 3) in int8."""
    k2 = tw.w3.shape[1] // cin                   # w8a8 w3 is (3, k*k*C)
    px = HEIGHT * WIDTH
    n_bytes = h.numel() * h.element_size() + 16 * px * 3
    return bound(n_bytes, [(2 * px * 36 * cin * cin, BF16_FLOP_S),
                           (2 * px * (144 * cin * cin + 48 * k2 * cin),
                            INT8_OP_S)])


def k3_bound(x: torch.Tensor, blocks) -> tuple[float, str]:
    """Bound of the body's K3 launches per frame: each block reads x and
    its weights once and writes its output once; C*E + 9E + E*C
    multiply-adds per pixel in bf16."""
    px, c = x.numel() // x.shape[-1], x.shape[-1]
    n_bytes, ops = 0, 0
    for w in blocks:
        weights = [w.we, w.be, w.wd, w.bd, w.wp, w.bp]
        n_bytes += 2 * x.numel() * x.element_size() + sum(
            t.numel() * t.element_size() for t in weights if t is not None)
        e = w.e_dim
        ops += 2 * px * ((c * e if w.has_expand else 0) + 9 * e + e * c)
    return bound(n_bytes, [(ops, BF16_FLOP_S)])


def seeded_flax_tree(model: torch.nn.Module, rng: np.random.Generator,
                     body_gain: float = 1.0, out_gain: float = 0.5):
    """Flax-layout (params, batch_stats) trees for `model` from numpy:
    LeCun-normal kernels (HWIO), small biases, BN statistics near identity,
    PReLU slopes in [0.05, 0.3].  Body kernels after the stem are scaled by
    body_gain, and the output conv by out_gain, so that tanh stays out of
    saturation and the frame is not flat."""
    params, stats = {}, {}
    for name, t in model.state_dict().items():
        *path, leaf = name.split(".")
        shape = tuple(t.shape)
        if leaf == "weight":
            o, i, kh, kw = shape
            a = rng.standard_normal((kh, kw, i, o)) / np.sqrt(kh * kw * i)
            if path[-1] == "out_conv":
                a *= out_gain
            elif path[0] == "body" and path[-1] != "Conv_0":
                a *= body_gain
            leaf = "kernel"
        elif leaf == "alpha":
            a = rng.uniform(0.05, 0.3, shape)
        elif leaf == "scale":
            a = rng.uniform(0.8, 1.2, shape)
        elif leaf == "var":
            a = rng.uniform(0.5, 1.5, shape)
        else:                                   # conv/BN bias, BN mean
            a = rng.standard_normal(shape) * 0.05
        tree = stats if leaf in ("mean", "var") else params
        for p in path:
            tree = tree.setdefault(p, {})
        tree[leaf] = a.astype(np.float32)
    return params, stats


def seeded_frame(rng: np.random.Generator, height: int, width: int,
                 device) -> torch.Tensor:
    """A video-like (H, W, 3) frame in [0, 1]: smooth colour waves plus
    sensor noise."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32) / 97.0
    phase = rng.uniform(0, 2 * np.pi, 3)
    f = 0.5 + 0.35 * np.sin(yy[..., None] * (1 + phase / 7)
                            + xx[..., None] * (0.7 + phase / 5) + phase)
    f += 0.04 * rng.standard_normal((height, width, 3))
    return torch.from_numpy(np.clip(f, 0, 1).astype(np.float32)).to(device)


def u8_diff(a: torch.Tensor, b: torch.Tensor) -> tuple[int, float]:
    d = (a.int() - b.int()).abs()
    return int(d.max()), float((d > 0).float().mean())


def check_bound(what: str, a: torch.Tensor, b: torch.Tensor,
                exact: bool = False) -> int:
    """Kernel vs twin: within MAX_DIFF on < MAX_FRAC, or (exact) equal."""
    dmax, frac = u8_diff(a, b)
    print(f"  {what}: max |du8| {dmax}, bytes differing {frac:.3e}")
    if dmax > MAX_DIFF or frac >= MAX_FRAC or (exact and dmax):
        raise AssertionError(f"{what}: kernel and twin disagree (max "
                             f"{dmax}, fraction {frac:.3e})")
    return dmax


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps runs, by CUDA events, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def engine_fps(run, frames, n: int) -> float:
    """Frames/s of run over n frames alternating, host clock, after
    two warm-up frames; ends in a synchronize."""
    for f in frames:
        run(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        run(frames[i % len(frames)])
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def seeded_model(fam: Family, rng, dev):
    model = build_generator(fam.name, device=dev)
    return from_jax_params(model, *seeded_flax_tree(
        model, rng, fam.body_gain, fam.out_gain))


def kernel_vs_twin(label: str, fam: Family, model, dev):
    """Phase 3/3b: the family's kernel vs its twin on seeded h at the
    1080p main-path shapes.  Returns (h, grid, tail weights by mode, max
    error)."""
    ny, nx, cr = ke.plan_grid(HEIGHT, WIDTH, 27)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h = (torch.randn((ny * nx, cr + 4, tail_ops.T, fam.cin), generator=gen,
                     device=dev) * 0.5).to(torch.bfloat16)
    tails = {"bf16": fam.prepare(model.tail),
             "w8a8": fam.prepare(model.tail, q8_calib=h[:16])}
    print(f"phase {label} {fam.kernel.__name__} vs twin: h "
          f"{tuple(h.shape)} bf16, grid {ny}x{nx}, core_rows {cr}")
    max_err = 0
    for mode, tw in tails.items():
        for bgr in (False, True):
            args = (h, tw, ny, nx, HEIGHT, WIDTH, bgr)
            got = fam.kernel(*args)
            torch.cuda.synchronize()
            want = fam.twin(*args)
            torch.cuda.synchronize()
            assert got.shape == (4 * HEIGHT, 4 * WIDTH, 3)
            max_err = max(max_err, check_bound(
                f"{mode} {'bgr' if bgr else 'rgb'}", got, want,
                exact=mode == "w8a8"))
    return h, (ny, nx, cr), tails, max_err


def k3_vs_plain(model, dev):
    """Phase 3c: K3 vs its plain version at the 1080p body shape, on the
    seeded model's block 0 (no expand) and block 1 (expand).  Returns (x,
    the six blocks' weights, max |error|, whether bit-identical)."""
    ny, nx, cr = ke.plan_grid(HEIGHT, WIDTH, 27)
    body = ke.prepare_fsrgan_engine(model, HEIGHT, WIDTH)[0]
    blocks = mbconv.build_mbconv_fsrgan_body(body).blocks
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = (torch.randn((ny * nx, cr + 4, tail_ops.T, mbconv.C), generator=gen,
                     device=dev) * 0.5).to(torch.bfloat16)
    ring = float((blocks[1].be > 0).float().mean())
    print(f"phase 3c fused_mbconv vs plain: x {tuple(x.shape)} bf16, "
          f"be > 0 on {ring:.2f} of block 1's channels")
    if ring == 0:
        raise AssertionError("seeded be <= 0: the ring is not exercised")
    max_err, exact = 0.0, True
    for i in (0, 1):
        got = mbconv.fused_mbconv(x, blocks[i])
        torch.cuda.synchronize()
        want = mbconv.fused_mbconv_reference(x, blocks[i])
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        d = (g - w).abs()
        # one bf16 ulp at |want|: 2**(floor(log2|want|) - 7)
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
                         - 7)
        frac = float((d > 0).float().mean())
        print(f"  block {i} ({'expand' if blocks[i].has_expand else 'no expand'}"
              f"): max |d| {float(d.max()):.3e}, outputs differing "
              f"{frac:.3e}, max in ulps {float((d / ulp).max()):.1f}")
        if bool((d > ulp).any()) or frac >= MAX_FRAC:
            raise AssertionError(f"K3 block {i} disagrees with its plain "
                                 "version")
        max_err = max(max_err, float(d.max()))
        exact = exact and frac == 0
    return x, blocks, max_err, exact


def k3_main_path(model, frames, exact: bool):
    """Phase 4c: the K3-body engine as a user builds it, on MAIN_FRAMES
    alternating frames, counts zeroed just before and read just after; then
    against the plain-body engine and the plain-K3 engine on the same
    weights and tail.  Returns (launches, K3 engine, plain-body engine)."""
    body, tw, brc = ke.prepare_mbconv_fsrgan_engine(
        model, HEIGHT, WIDTH, q8_calib_frame=frames[0])
    engine = ke.build_kernel_engine(body, tw, HEIGHT, WIDTH, brc=brc)
    reset_counts()
    outs = [engine(frames[i % 2]) for i in range(MAIN_FRAMES)]
    torch.cuda.synchronize()
    launches = all_counts()
    print(f"phase 4c fsrgan engine, K3 body: {MAIN_FRAMES} frames "
          f"{HEIGHT}x{WIDTH} -> {tuple(outs[0].shape)} {outs[0].dtype} on "
          f"{outs[0].device}; launches {launches}")
    want = {k: 0 for k in launches}
    want.update(fused_mbconv=6 * MAIN_FRAMES, fused_tail_u8=MAIN_FRAMES)
    if launches != want:
        raise AssertionError("the K3-body engine did not run K3 6 times and "
                             f"K1 once per frame, and nothing else: {launches}")
    check_frames(outs)
    plain = ke.prepare_fsrgan_engine(model, HEIGHT, WIDTH, brc)[0]
    p_eng = ke.build_kernel_engine(plain, tw, HEIGHT, WIDTH, brc=brc)
    r_eng = ke.build_kernel_engine(
        mbconv.build_mbconv_fsrgan_body(plain, mbconv.fused_mbconv_reference),
        tw, HEIGHT, WIDTH, brc=brc)

    def f32_body(tiles):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return model.body(tiles.float()).to(torch.bfloat16)

    f_eng = ke.build_kernel_engine(f32_body, tw, HEIGHT, WIDTH, brc=brc)
    p_out, r_out, f_out = (e(frames[1]) for e in (p_eng, r_eng, f_eng))
    torch.cuda.synchronize()
    shares = {}
    for name, a, b in (("K3-body engine vs plain-body engine", outs[1], p_out),
                       ("K3-body engine vs f32-body engine", outs[1], f_out),
                       ("plain-body engine vs f32-body engine", p_out, f_out)):
        d = (a.int() - b.int()).abs()
        shares[name] = (float((d > 0).float().mean()),
                        float((d > 1).float().mean()))
        print(f"  {name} (w8a8, same tail): max |du8| {int(d.max())}, > 0 on "
              f"{shares[name][0]:.3e}, > 1 on {shares[name][1]:.3e}")
    k3_f32 = shares["K3-body engine vs f32-body engine"]
    plain_f32 = shares["plain-body engine vs f32-body engine"]
    if k3_f32[0] > plain_f32[0] or k3_f32[1] > plain_f32[1]:
        raise AssertionError("the K3-body engine is farther from the f32-body "
                             "engine than the plain-body engine is")
    check_bound("K3-body engine vs plain-K3-body engine", outs[1], r_out,
                exact=exact)
    return launches, engine, p_eng


def k3_times(model, frames, x, blocks, k_eng, p_eng):
    """Phase 5 for K3: (kernel ms, plain ms) per frame of six blocks, the
    six plain InvertedResidual modules on cuDNN, and both engines' fps."""
    reps = 10
    k_ms = cuda_ms(lambda: [mbconv.fused_mbconv(x, w) for w in blocks], reps)
    p_ms = cuda_ms(lambda: [mbconv.fused_mbconv_reference(x, w)
                            for w in blocks], 1)
    body = ke.prepare_fsrgan_engine(model, HEIGHT, WIDTH)[0]
    xc = x.permute(0, 3, 1, 2)
    mods = [getattr(body, f"InvertedResidual_{i}") for i in range(len(blocks))]
    with torch.inference_mode():
        lib_ms = cuda_ms(lambda: [m(xc) for m in mods], reps)
    b_ms, b_by = k3_bound(x, blocks)
    print(f"  K3, {len(blocks)} launches at x {tuple(x.shape)}: kernel "
          f"{k_ms:.2f} ms/frame, plain version {p_ms:.2f}, plain "
          f"InvertedResidual modules (bf16, cuDNN) {lib_ms:.2f}, bound "
          f"{b_ms:.3f} ({b_by})")
    fps_k = engine_fps(k_eng, frames, TIMED_FRAMES)
    fps_p = engine_fps(p_eng, frames, TIMED_FRAMES)
    print(f"  fsrgan engine 1080p->4K w8a8: K3 body {fps_k:.2f} frames/s, "
          f"plain body {fps_p:.2f} frames/s")
    return k_ms, p_ms, lib_ms, b_ms, b_by


def check_frames(outs) -> None:
    """Engine outputs: shape, dtype, device, not flat, deterministic."""
    for out in outs:
        if out.shape != (4 * HEIGHT, 4 * WIDTH, 3) or \
                out.dtype != torch.uint8 or out.device.type != "cuda":
            raise AssertionError(f"bad engine output {tuple(out.shape)} "
                                 f"{out.dtype} {out.device}")
    std = outs[1].float().std(dim=(0, 1))
    print(f"  per-channel std {[round(float(s), 2) for s in std]} "
          f"(floor {STD_FLOOR}), mean "
          f"{[round(float(m), 2) for m in outs[1].float().mean(dim=(0, 1))]}")
    if float(std.min()) <= STD_FLOOR:
        raise AssertionError("engine output is flat")
    if u8_diff(outs[0], outs[2]) != (0, 0.0):
        raise AssertionError("same frame, different output")


def main_path(label: str, fam: Family, model, frames) -> dict[str, int]:
    """Phase 4/4b: the family's engine, as a user builds it, on
    MAIN_FRAMES alternating frames; every tail's launch count is zeroed just
    before and read just after.  Returns those counts."""
    engine = fam.build(model, HEIGHT, WIDTH, q8_calib_frame=frames[0])
    reset_counts()
    outs = [engine(frames[i % 2]) for i in range(MAIN_FRAMES)]
    torch.cuda.synchronize()
    launches = all_counts()
    print(f"phase {label} {fam.name} engine: {MAIN_FRAMES} frames "
          f"{HEIGHT}x{WIDTH} -> {tuple(outs[0].shape)} {outs[0].dtype} on "
          f"{outs[0].device}; launches {launches}")
    want = {k: MAIN_FRAMES if k == fam.kernel.__name__ else 0
            for k in launches}
    if launches != want:
        raise AssertionError(f"main path did not run {fam.kernel.__name__} "
                             f"once per frame and nothing else: {launches}")
    check_frames(outs)
    return launches


def engine_pair(fam: Family, model, frames):
    """The engine with the kernel tail and with the twin tail, on one
    calibration; the two agree within the kernel-vs-twin bound."""
    body, tw, brc = fam.prepare_engine(model, HEIGHT, WIDTH,
                                       q8_calib_frame=frames[0])
    k_eng = ke.build_kernel_engine(body, tw, HEIGHT, WIDTH, brc=brc,
                                   tail_fn=fam.kernel)
    t_eng = ke.build_kernel_engine(body, tw, HEIGHT, WIDTH, brc=brc,
                                   tail_fn=fam.twin)
    k_out, t_out = k_eng(frames[1]), t_eng(frames[1])
    torch.cuda.synchronize()
    err = check_bound("engine, kernel vs twin tail", k_out, t_out,
                      exact=True)
    return body, k_eng, t_eng, err


def check_input_options(fam: Family, model, frames) -> None:
    """u8_input and bgr_input on the card, on frames[1] as uint8.
    u8: the u8_input + bgr_input engine on the uint8 BGR frame equals, byte
    for byte, the bgr_input engine on the same frame as float (u8 / 255,
    divided on the host: CUDA divides by a scalar as a multiply by its
    reciprocal), both w8a8 calibrated on frames[0]: the u8 levels normalise
    to the bf16 values the float path rounds them to, so the tiles are
    equal and all that follows.  BGR: the u8 BGR engine against the float
    RGB engine, within the whole-slice envelopes of
    tests/test_torch_engine_srgan.py (bf16 max <= 1 on < 5%; w8a8 max <= 3,
    > 1 on < 1%): the flipped stem sums its input channels in another order
    and the body carries the differences on."""
    frame_u8 = (frames[1] * 255 + 0.5).to(torch.uint8)
    bgr_u8 = frame_u8.flip(-1).contiguous()
    levels = torch.from_numpy(np.arange(256, dtype=np.float32)
                              / np.float32(255)).to(frame_u8.device)
    rgb01, bgr01 = levels[frame_u8.long()], levels[bgr_u8.long()]

    def run(frame, **kw):
        return fam.build(model, HEIGHT, WIDTH, **kw)(frame)

    q8 = dict(q8_calib_frame=frames[0])
    u8 = {"w8a8": run(bgr_u8, u8_input=True, bgr_input=True, **q8),
          "bf16": run(bgr_u8, u8_input=True, bgr_input=True)}
    f32 = run(bgr01, bgr_input=True, **q8)
    rgb = {"w8a8": run(rgb01, **q8), "bf16": run(rgb01)}
    torch.cuda.synchronize()
    dmax, frac = u8_diff(u8["w8a8"], f32)
    print(f"  u8 BGR input engine vs float BGR input engine (w8a8): max "
          f"|du8| {dmax}, bytes differing {frac:.3e}")
    if dmax:
        raise AssertionError("u8 input engine differs from the float one")
    for mode, (max_d, over, max_frac) in (("bf16", (1, 0, 0.05)),
                                          ("w8a8", (3, 1, 0.01))):
        d = (u8[mode].int() - rgb[mode].int()).abs()
        dmax, frac0 = int(d.max()), float((d > 0).float().mean())
        frac1 = float((d > 1).float().mean())
        print(f"  {mode} u8 BGR input engine vs float RGB engine: max |du8| "
              f"{dmax}, > 0 on {frac0:.3e}, > 1 on {frac1:.3e}")
        if dmax > max_d or float((d > over).float().mean()) >= max_frac:
            raise AssertionError(f"{mode} u8 BGR input engine disagrees "
                                 "with the float RGB engine")


def check_plain_tail(model, rng, dev, height: int = 135,
                     width: int = 240) -> None:
    """Small input: the bf16 kernel tail vs the plain f32 FSRGANTail module
    (TF32 off) on the same bf16 body output, per tile and crop-stitched,
    with the JAX package's envelope for this comparison
    (tests/test_pallas_tail.py: max <= 3, > 1 on < 1%)."""
    frame = seeded_frame(rng, height, width, dev)
    body, tw, brc = ke.prepare_fsrgan_engine(model, height, width)
    ny, nx, cr = ke.plan_grid(height, width, brc)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        h = body(ke._tiles(frame, ny, nx, cr)).contiguous()
        got = tail_ops.fused_tail_u8(h, tw, ny, nx, height, width)
        fine = model.tail(h.float())
    core = fine[:, 8:8 + 4 * cr, 8:8 + 4 * tail_ops.CORE]
    core = core.reshape(ny, nx, 4 * cr, 4 * tail_ops.CORE, 3)
    core = core.permute(0, 2, 1, 3, 4).reshape(ny * 4 * cr, -1, 3)
    want = (((core[:4 * height, :4 * width] + 1) / 2).clamp(0, 1) * 255
            + 0.5).to(torch.uint8)
    d = (got.int() - want.int()).abs()
    dmax, frac = int(d.max()), float((d > 1).float().mean())
    print(f"  bf16 kernel tail vs plain f32 tail at {height}x{width}: "
          f"max |du8| {dmax}, > 1 on {frac:.3e}")
    if dmax > 3 or frac >= 0.01:
        raise AssertionError("kernel tail disagrees with the plain tail")


def times(fam: Family, model, frames, h, grid, tails, body,
          k_eng, t_eng) -> dict[str, tuple[float, float]]:
    """Phase 5 for one family; returns {mode: (kernel ms, twin ms)}."""
    ny, nx, cr = grid
    twin_reps = 1 if fam.cin > 32 else 3
    fps_k = engine_fps(k_eng, frames, TIMED_FRAMES)
    fps_t = engine_fps(t_eng, frames, twin_reps)
    print(f"  {fam.name} engine 1080p->4K w8a8: kernel tail {fps_k:.2f} "
          f"frames/s, twin tail {fps_t:.2f} frames/s")
    tiles = ke._tiles(frames[1], ny, nx, cr)
    with torch.inference_mode():
        body_ms = cuda_ms(lambda: body(tiles), 5)
    print(f"  {fam.name} body (bf16, {ny * nx} tiles): {body_ms:.2f} "
          f"ms/frame")
    ms = {}
    for mode, tw in tails.items():
        args = (h, tw, ny, nx, HEIGHT, WIDTH)
        ms[mode] = (cuda_ms(lambda: fam.kernel(*args), 10),
                    cuda_ms(lambda: fam.twin(*args), twin_reps))
        print(f"  {fam.name} tail {mode}: kernel {ms[mode][0]:.2f} ms/frame,"
              f" twin {ms[mode][1]:.2f} ms/frame")
    # The twin is built to be exact, not fast; the bf16 tail module on
    # cuDNN (per tile, without crop-stitch or u8) shows what a library tail
    # costs.
    cudnn_tail = fam.tail_cls(dtype=torch.bfloat16).to(h.device).eval()
    cudnn_tail.load_state_dict(model.tail.state_dict())
    with torch.inference_mode():
        cudnn_ms = cuda_ms(lambda: cudnn_tail(h), 3)
    print(f"  {fam.name} tail, bf16 {fam.tail_cls.__name__} module on cuDNN "
          f"(no crop, no u8): {cudnn_ms:.2f} ms/frame")
    return ms


def main() -> None:
    # ---- phase 1: device
    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"phase 1 device: {kind}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # ---- phase 2: build
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"phase 2 build: {build_s:.1f} s (nvcc of csrc/*.cu, set-up)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(SEED)
    models = {f.name: seeded_model(f, rng, dev) for f in FAMILIES}

    # ---- phase 3 / 3b / 3c: kernels vs twins at the main-path shapes
    checked = {f.name: kernel_vs_twin(label, f, models[f.name], dev)
               for label, f in zip(("3", "3b"), FAMILIES)}
    x3, blocks3, err3, exact3 = k3_vs_plain(models["fsrgan"], dev)

    # ---- phase 4 / 4b: the main paths, 1080p -> 4K
    frames = [seeded_frame(rng, HEIGHT, WIDTH, dev) for _ in range(2)]
    launches, pairs, errs = {}, {}, {}
    for label, fam in zip(("4", "4b"), FAMILIES):
        model = models[fam.name]
        launches[fam.name] = main_path(label, fam, model, frames)
        pairs[fam.name] = engine_pair(fam, model, frames)
        errs[fam.name] = max(checked[fam.name][3], pairs[fam.name][3])
        if fam.name == "fsrgan":
            check_plain_tail(model, rng, dev)
        else:
            check_input_options(fam, model, frames)
    # ---- phase 4c: the FSRGAN engine with the K3 body
    launches3, k3_eng, plain_eng = k3_main_path(models["fsrgan"], frames,
                                                exact3)

    # ---- phase 5: times
    print(f"phase 5 times [{smi}]:")
    ms = {}
    for fam in FAMILIES:
        h, grid, tails, _ = checked[fam.name]
        body, k_eng, t_eng, _ = pairs[fam.name]
        ms[fam.name] = times(fam, models[fam.name], frames, h, grid,
                             tails, body, k_eng, t_eng)

    k3 = k3_times(models["fsrgan"], frames, x3, blocks3, k3_eng, plain_eng)

    kernels = []
    for fam in FAMILIES:
        h, _, tails, _ = checked[fam.name]
        b_ms, b_by = tail_bound(h, tails["w8a8"], fam.cin)
        print(f"  {fam.name} tail w8a8 bound {b_ms:.3f} ms/frame ({b_by})")
        kernels.append({
            "name": fam.kernel.__name__, "route": "cuda",
            "source": fam.source, "replaces": fam.replaces,
            "launches": launches[fam.name][fam.kernel.__name__],
            "max_abs_err": errs[fam.name],
            "ms": ms[fam.name]["w8a8"][0], "plain_ms": ms[fam.name]["w8a8"][1],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    kernels.append({
        "name": "fused_mbconv", "route": "cuda",
        "source": "denoise_gan_tpu_torch/csrc/mbconv.cu",
        "replaces": "tools/exp_mbconv_kernel.py:37",
        "launches": launches3["fused_mbconv"], "max_abs_err": err3,
        "ms": k3[0], "plain_ms": k3[1], "bound_ms": k3[3],
        "bound_by": k3[4], "library_ms": None})
    record = {"kernels": kernels}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
