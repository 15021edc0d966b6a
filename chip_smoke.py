#!/usr/bin/env python3
"""Smoke run of the PyTorch port (denoise_gan_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each printed on its own line:
1. device: needs torch.cuda; prints nvidia-smi's name and power limit.
2. build: compiles csrc/*.cu with nvcc into the package's _build/.
3. kernel vs twin: the fused tail kernel against its plain PyTorch twin at
   the 1080p main-path shapes (h (128, 139, 124, 32) bf16, 8x16 tiles,
   core_rows 135), bf16 and w8a8, RGB and BGR.  Bound: max |du8| <= 1 on
   < 1e-3 of the bytes.
4. engine: the full-width FSRGAN generator (gf=32, 6 blocks) from
   numpy-seeded weights, 1080p -> 4K through build_fsrgan_kernel_engine
   (w8a8, calibrated on the first frame) on two alternating seeded frames.
   Checks shape, dtype, device, that the kernel ran once per frame and the
   twin never, that the output is not flat, the same engine with the twin
   as tail within the phase-3 bound, and, on a small input, the bf16 kernel
   tail against the plain f32 FSRGANTail module.
5. times: engine frames/s (kernel vs twin tail), tail ms/frame (kernel vs
   twin, and a bf16 tail module on cuDNN), body ms/frame, each beside the
   card's name and power limit.

Any failure raises, and the run exits non-zero.  The line before the last
is the kernels' JSON record, the last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from denoise_gan_tpu_torch.infer import kernel_engine as ke
from denoise_gan_tpu_torch.io.params import from_jax_params
from denoise_gan_tpu_torch.models import build_generator
from denoise_gan_tpu_torch.models.fsrgan import FSRGANTail
from denoise_gan_tpu_torch.ops import _build
from denoise_gan_tpu_torch.ops import tail as tail_ops
from denoise_gan_tpu_torch.utils.device import require_cuda

HEIGHT, WIDTH = 1080, 1920
SEED = 0
MAX_DIFF, MAX_FRAC = 1, 1e-3      # u8 bound, kernel vs twin
STD_FLOOR = 8.0                   # per-channel u8 std of a non-flat frame
MAIN_FRAMES = 4                   # frames driven through the main path
TIMED_FRAMES = 10


def seeded_flax_tree(model: torch.nn.Module, rng: np.random.Generator):
    """Flax-layout (params, batch_stats) trees for `model` from numpy:
    LeCun-normal kernels (HWIO), small biases, BN statistics near identity,
    PReLU slopes in [0.05, 0.3].  The output conv is scaled down so tanh
    stays out of saturation."""
    params, stats = {}, {}
    for name, t in model.state_dict().items():
        *path, leaf = name.split(".")
        shape = tuple(t.shape)
        if leaf == "weight":
            o, i, kh, kw = shape
            a = rng.standard_normal((kh, kw, i, o)) / np.sqrt(kh * kw * i)
            if path[-1] == "out_conv":
                a *= 0.5
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


def check_bound(what: str, a: torch.Tensor, b: torch.Tensor) -> int:
    dmax, frac = u8_diff(a, b)
    print(f"  {what}: max |du8| {dmax}, bytes differing {frac:.3e}")
    if dmax > MAX_DIFF or frac >= MAX_FRAC:
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
    card = f"[{smi}]"

    # ---- phase 2: build
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"phase 2 build: {build_s:.1f} s (nvcc of csrc/*.cu, set-up)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(SEED)
    model = build_generator("fsrgan", device=dev)
    from_jax_params(model, *seeded_flax_tree(model, rng))

    # ---- phase 3: kernel vs twin at the main-path shapes
    ny, nx, cr = ke.plan_grid(HEIGHT, WIDTH, 27)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h = (torch.randn((ny * nx, cr + 4, tail_ops.T, 32), generator=gen,
                     device=dev) * 0.5).to(torch.bfloat16)
    tails = {"bf16": tail_ops.prepare_tail(model.tail),
             "w8a8": tail_ops.prepare_tail(model.tail, q8_calib=h[:16])}
    print(f"phase 3 kernel vs twin: h {tuple(h.shape)} bf16, grid "
          f"{ny}x{nx}, core_rows {cr}")
    max_err = 0
    for mode, tw in tails.items():
        for bgr in (False, True):
            args = (h, tw, ny, nx, HEIGHT, WIDTH, bgr)
            got = tail_ops.fused_tail_u8(*args)
            torch.cuda.synchronize()
            want = tail_ops.fused_tail_u8_reference(*args)
            torch.cuda.synchronize()
            assert got.shape == (4 * HEIGHT, 4 * WIDTH, 3)
            max_err = max(max_err, check_bound(
                f"{mode} {'bgr' if bgr else 'rgb'}", got, want))

    # ---- phase 4: the main path, 1080p -> 4K
    frames = [seeded_frame(rng, HEIGHT, WIDTH, dev) for _ in range(2)]
    engine = ke.build_fsrgan_kernel_engine(model, HEIGHT, WIDTH,
                                           q8_calib_frame=frames[0])
    for k in tail_ops.launch_counts:
        tail_ops.launch_counts[k] = 0
    outs = [engine(frames[i % 2]) for i in range(MAIN_FRAMES)]
    torch.cuda.synchronize()
    launches = dict(tail_ops.launch_counts)
    print(f"phase 4 engine: {MAIN_FRAMES} frames {HEIGHT}x{WIDTH} -> "
          f"{tuple(outs[0].shape)} {outs[0].dtype} on {outs[0].device}; "
          f"launches {launches}")
    if launches["fused_tail_u8"] != MAIN_FRAMES or \
            launches["fused_tail_u8_reference"] != 0:
        raise AssertionError(f"main path did not run the kernel once per "
                             f"frame: {launches}")
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
    body, tw, brc = ke.prepare_fsrgan_engine(model, HEIGHT, WIDTH,
                                             q8_calib_frame=frames[0])
    k_eng = ke.build_kernel_engine(body, tw, HEIGHT, WIDTH, brc=brc)
    t_eng = ke.build_kernel_engine(
        body, tw, HEIGHT, WIDTH, brc=brc,
        tail_fn=tail_ops.fused_tail_u8_reference)
    k_out, t_out = k_eng(frames[1]), t_eng(frames[1])
    torch.cuda.synchronize()
    max_err = max(max_err, check_bound("engine, kernel vs twin tail",
                                       k_out, t_out))
    check_plain_tail(model, rng, dev)

    # ---- phase 5: times
    fps_k = engine_fps(k_eng, frames, TIMED_FRAMES)
    fps_t = engine_fps(t_eng, frames, 3)
    print(f"phase 5 times {card}:")
    print(f"  engine 1080p->4K w8a8: kernel tail {fps_k:.2f} frames/s, "
          f"twin tail {fps_t:.2f} frames/s")
    tiles = ke._tiles(frames[1], ny, nx, cr)
    with torch.inference_mode():
        body_ms = cuda_ms(lambda: body(tiles), 5)
    print(f"  body (bf16, 128 tiles): {body_ms:.2f} ms/frame")
    ms = {}
    for mode, tw_m in tails.items():
        args = (h, tw_m, ny, nx, HEIGHT, WIDTH)
        ms[mode] = (cuda_ms(lambda: tail_ops.fused_tail_u8(*args), 10),
                    cuda_ms(lambda: tail_ops.fused_tail_u8_reference(*args),
                            3))
        print(f"  tail {mode}: kernel {ms[mode][0]:.2f} ms/frame, twin "
              f"{ms[mode][1]:.2f} ms/frame")
    # The twin is built to be exact, not fast; a bf16 FSRGANTail on cuDNN
    # (per tile, without crop-stitch or u8) shows what a library tail costs.
    cudnn_tail = FSRGANTail(dtype=torch.bfloat16).to(dev).eval()
    cudnn_tail.load_state_dict(model.tail.state_dict())
    with torch.inference_mode():
        cudnn_ms = cuda_ms(lambda: cudnn_tail(h), 3)
    print(f"  tail, bf16 FSRGANTail module on cuDNN (no crop, no u8): "
          f"{cudnn_ms:.2f} ms/frame")

    record = {"kernels": [{
        "name": "fused_tail_u8", "route": "cuda",
        "source": "denoise_gan_tpu_torch/csrc/tail.cu",
        "replaces": "denoise_gan_tpu/ops/pallas/tail.py:290",
        "launches": launches["fused_tail_u8"], "max_abs_err": max_err,
        "ms": ms["w8a8"][0], "plain_ms": ms["w8a8"][1]}]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
