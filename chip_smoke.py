#!/usr/bin/env python3
"""Smoke run of the PyTorch port (denoise_gan_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each printed on its own line:
1. device: needs torch.cuda; prints nvidia-smi's name and power limit.
2. build: compiles csrc/*.cu with nvcc into the package's _build/.
3. K1 vs twin: the FSRGAN fused tail kernel (csrc/tail.cu) against its
   plain PyTorch twins at the 1080p main-path shapes (h (128, 139, 124, 32),
   8x16 tiles, core_rows 135): the u8 epilogue in bf16, w8a8 and qh8 (h
   from quantize_h of the seeded h), RGB and BGR, and the canvas epilogue
   in the three modes.  Bound: max |du8| <= 1 on < 1e-3 of the bytes; the
   canvas within 2**-8 (one bf16 rounding at the top of tanh's range) on
   < 1e-3 of the values (bf16: < 2e-3, bf16 values round apart more often
   than bytes).  w8a8 u8 must be bit-identical; for qh8 and the int8
   canvases bit-identity is the target, and each line says if it held.
3b. K2 vs twin: the SRGAN fused tail kernel (csrc/tail_srgan.cu) the same
   way, at h (128, 139, 124, 64).
3c. K3 vs its plain version: the fused inverted residual (csrc/mbconv.cu)
   at the 1080p body shape x (128, 139, 124, 32) bf16, with and without
   the expand, on the seeded FSRGAN blocks (non-zero BN statistics, so
   relu(be) > 0 and the zero ring of the expanded tensor matters).  Target:
   bit-identical; bound: within 1 bf16 ulp on < 1e-3 of the outputs.
3d. The probes vs their plain versions at the JAX probes' shapes (no frame
   path runs them).  K9 (csrc/probe_fma.cu) at x (512, 1024), seeded as
   tools/exp_vpu_peak.py: the FMA chain (256 steps) and the roll + FMA
   chain (128 steps) bit-identical to their plain versions, which round
   each multiply-add once as fmaf does (fma_peak.fma_f32).  K6 (csrc/probe_mma.cu) at y
   (K, 3840), K in (128, 384, 1152), from the probe's initial state: int8
   bit-identical to the float64 plain version after 2000 steps (there it
   saturates at 127 within two steps, so also from a random state of both
   signs after RANDOM_STEPS steps); bf16 at steps 1-16 only (the chain
   overflows to inf, then NaN, well before step 100), each step from the
   kernel's previous state within int8_chain.bf16_step_bound (one bf16
   rounding after f32 sums in another order), rows >= 128 unchanged, and
   one 16-step launch equal to the 16 single steps; the same from a random
   state.  K8 (csrc/probe_relayout.cu): the product kernel's LDSM (.trans
   among them) and HMMA counts by cuobjdump (printed); matmul_form in both
   operand forms at the JAX shapes (2048, 384, 128), (2048, 1152, 128),
   (1024, 1152, 48) with 64 reps, every element of y within
   relayout.product_bound of the float64 plain version (K * 2**-24 *
   sum |x w|: f32 sums in another order) and acc within
   relayout.acc_bound; the transpose chain at (1536, 128) x 8 iterations
   bit-identical.  K10 (csrc/probe_u8.cu): the u8 phase store at (1024,
   48) and at a 4K frame's (518400, 48), drawn on the card, bit-identical
   (tanhf is torch's CUDA tanh; every step rounded apart on both sides).
   K7 (csrc/probe_overlap.cu) from the probe's initial state, y (128,
   15360) bf16, z (8, 15360) f32: the loops of its SASS by cuobjdump
   (printed; mode both's loop must hold HMMA and SHFL); modes mxu and both
   for 8 single steps from the kernel's previous state, y within
   overlap.step_bound (one bf16 rounding after f32 sums in another order),
   z bit-identical, and one 8-step launch equal to them; each mode at the
   JAX counts (4000, 0), (0, 3000), (4000, 3000), z bit-identical to the
   plain version (fmaf(z, c1, roll * c2) on both sides) and y's columns
   128.. unchanged (y itself overflows to NaN near step 55).  K4
   (csrc/probe_dw.cu): each form at e (192, 2176) f32 bit-identical to its
   plain version (fmaf in the JAX order on both sides) at 1, 37 and 2000
   reps, and chunked apart from scratch after one rep exactly at columns 0
   and 127 of each output chunk.
4. FSRGAN engine: the full-width FSRGAN generator (gf=32, 6 blocks) from
   numpy-seeded weights, 1080p -> 4K through build_fsrgan_kernel_engine on
   two alternating seeded frames, once per main path: w8a8 (calibrated on
   the first frame), qh8 (the same calibration), bf16, and the float-output
   engine (out_uint8=False, the canvas epilogue) on one frame.  Each run
   zeroes the launch counts just before and reads them just after: K1 ran
   once per frame in that path's epilogue and mode, and nothing else.
   Checks shape, dtype, device, that the output is not flat, the float
   frame's (4320, 7680, 3) f32 in [0, 1] and its trunc(x*255 + 0.5)
   against the u8 engine (max 1 on < 1e-3), the w8a8 and the qh8 engine
   with the twin as tail within the phase-3 bound (bit-identical), and, on
   a small input, the bf16 kernel tail against the plain f32 FSRGANTail
   module.  Prints qh8 against w8a8: the JAX package's qh8 envelope (max
   <= 2, > 1 on < 5e-3) does not hold on these seeded weights, for the JAX
   package's engines as for the port's (PERF.md, section 6); phase 4d
   asserts it on the JAX package's initialisation.
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
4d. The whole-frame quality rule (the JAX package's tools/exp_q8_exact.py):
   per family, each engine mode against the exact whole-frame output, the
   plain bf16 generator on the whole 1080p frame edge-padded at the bottom
   and right to a multiple of 8 rows and 128 columns (as the JAX whole-frame
   engine, infer/engine.py:170-176), clip((y+1)/2) and trunc(x*255 + 0.5)
   as uint8, cropped.  Frames: a seeded u8-representable noise frame, and a
   structured scene-change frame with the int8 modes calibrated on the
   noise frame.  Modes: bf16, w8a8, qh8, u8q8-bgr (u8 BGR input and output,
   w8a8: the video CLI's production engine; noise frame only), and for
   FSRGAN the K3-body w8a8 engine; each over the whole frame and over its
   interior (the pixels at least INTERIOR coarse pixels from a tile seam
   and from the frame border).  Two weight sets: the seeded generators of
   the phases above, and the JAX package's own initialisers drawn with
   numpy (jax_init_tree; the weights tools/exp_q8_exact.py scores).  The
   rule (w8a8's share > 1 at most bf16's + 0.1 percentage point, qh8's at
   most w8a8's + 0.1 pp, the int8 modes' max at most bf16's + 2) and the
   JAX package's qh8 envelope (the qh8 engine within max 2, > 1 on < 5e-3,
   of the w8a8 engine) are printed for both and asserted on the JAX-init
   weights.  On the seeded weights they are printed only: there the JAX
   package's engines miss them by the same margins as the port's (PERF.md,
   section 6), so they measure the weights and modes, not the port.
   Asserted on both: in bf16 the engine equals the whole-frame output
   within 1 level on the interior (max <= 2, > 1 on < 1e-3: only summation
   order differs there), so every larger difference sits at the tile seams
   and frame borders.
5. times: per engine, frames/s (kernel vs twin tail, w8a8 and qh8), tail
   ms/frame (kernel vs twin, each mode and epilogue, and the bf16 tail
   module on cuDNN), quantize_h and body ms/frame; K3's six launches per
   frame vs its plain version and the six plain InvertedResidual modules on
   cuDNN, and the K3-body engine's frames/s beside the plain-body engine's;
   each beside the card's name and power limit.  Each kernel's bound (the
   larger of its bytes over 3.35 TB/s and its operations over the
   tensor-core peak for their type) is computed from the main path's
   shapes.  The probes: K9's ms per launch over 32 chained launches (the
   JAX probe's time_chained) at its iterations (printed: a few
   microseconds of work, where the wrapper's host time between launches
   dominates) and at LONG_ITERS (the kernels line, with the plain version
   timed once at the same count and held bit-identical there; the roll
   chain also on 4096 rows, 8 warps to a scheduler, printed), beside the
   FP32 peak (SMs x 128 lanes x 2 x clocks.max.sm); torch.matmul at the
   JAX probe's matmul shapes (the cuBLAS yardstick); K6's ms per 2000-step
   chain per K and type, its i8/bf16 ratio, its plain version, one step's
   product by torch.matmul / torch._int_mm (printed) and the whole chain
   through those calls (int8_chain.library_chain: library_ms).  Their
   bounds: K9's operations over the FP32 peak, K6's over the bf16 or int8
   tensor-core peak.  K8 and K10 kernels: ms per launch queued behind a
   device sleep (card.queued_ms: the wrapper's host time is not counted).
   K8: matmul_form per form and shape at the probe's 64 reps (the kernels
   line: ms, bound (operations over the bf16 peak), the plain version and
   the same reps through torch.matmul calls (library_ms), all at 64 reps)
   and at LONG_REPS (printed: no plain version runs at the long counts),
   T/s, and sublane / canonical at both; the transpose chain at 8
   iterations (the kernels line, with its bound (bytes), the plain
   version and the chain through .t().contiguous() and mul, all at 8) and
   at LONG_ITERS (printed), and its shared-memory floor.  K10 at (1024,
   48) and at the 4K frame (the kernels line; no single PyTorch call
   computes it), its bound (bytes) and its plain version.  K7: each
   mode's ms at the JAX counts (the kernels line, with the plain version
   timed in phase 3d and the same chains through torch.matmul /
   torch.roll + mul + add: library_ms) and at equal counts
   overlap.EQUAL_ITERS, the JAX probe's comparison (its t(c) runs both
   chains 4000 times) and the one at equal counts with the overlap share
   (t(a) + t(b) - t(c)) / min(t(a), t(b)); bounds: the product's
   operations over the bf16 peak, the roll's over the FP32 peak (and its
   shuffle floor, 32 a clock on one SM), the larger for both.  K4: each
   form's ms per 2000 reps and us per band step against the bound
   (operations over the FP32 peak) and the shared-memory floor, scaled by
   the TPU geometry's 7119 band steps a frame, beside the plain version
   and the chain through F.conv2d(groups=192) with cuDNN's TF32 off.

Any failure raises, and the run exits non-zero.  The line before the last
is the kernels' JSON record, the last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
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
from denoise_gan_tpu_torch.probes import (dw_forms, fma_peak, int8_chain,
                                          overlap, relayout, u8_store)
from denoise_gan_tpu_torch.utils import card
from denoise_gan_tpu_torch.utils.device import require_cuda

HEIGHT, WIDTH = 1080, 1920
SEED = 0
MAX_DIFF, MAX_FRAC = 1, 1e-3      # u8 bound, kernel vs twin
CANVAS_DIFF = 2.0 ** -8           # canvas bound: one rounding at |x| >= 0.5
# bf16 canvas: share of values that may differ; measured 1.11e-3 (K1) and
# 5.0e-4 (K2) at 1080p, 1.03e-3 at the 1x2x24 geometry of
# tests/test_torch_cuda.py, all on the H100
CANVAS_FRAC_BF16 = 2e-3
STD_FLOOR = 8.0                   # per-channel u8 std of a non-flat frame
MAIN_FRAMES = 4                   # frames driven through each main path
TIMED_FRAMES = 10
MODES = tail_ops.MODES
# phase 4d: coarse pixels from a tile seam or the frame border beyond which
# a bf16 engine pixel sees no per-tile SAME padding (measured on the CPU at
# 270x480: max 1 level there from 8 on for FSRGAN, from 4 for SRGAN)
INTERIOR = 8
# SRGAN residual-block and post-conv kernels at a tenth of LeCun normal, as
# tests/test_torch_engine_srgan.py: 16 residual adds then neither saturate
# tanh nor amplify bf16 rounding differences between two engines' bodies.
SRGAN_BODY_GAIN = 0.1
# H100 SXM peaks (NVIDIA's data sheet, dense): the bounds' rates
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
INT8_OP_S = 1979e12
# phase 3d: K6 bf16 checked step by step for BF16_STEPS steps (then the
# chain overflows on its way to inf and NaN), the random states for
# RANDOM_STEPS
BF16_STEPS = 16
RANDOM_STEPS = 100
# phase 3d: K7's y checked step by step for K7_STEPS steps (it overflows
# near step 55); K4 at these reps, and at dw_forms.REPS
K7_STEPS = 8
K4_REPS = (1, 37)


@dataclass(frozen=True)
class Family:
    """One 4x family's pieces: generator name, tail module class, body
    channels, tail preparation, the u8 and canvas kernel wrappers and their
    twins, their launch counts, the engine's constructor and preparation,
    the CUDA source, the TPU kernel it replaces, and the gains of the
    seeded body and output conv."""

    name: str
    tail_cls: type
    cin: int
    prepare: Callable
    kernel: Callable
    twin: Callable
    canvas: Callable
    canvas_twin: Callable
    counts: dict
    build: Callable
    prepare_engine: Callable
    source: str
    replaces: str
    body_gain: float
    out_gain: float

    def key(self, fn: Callable, mode: str) -> str:
        """The launch-count key of a wrapper in a mode."""
        return f"{fn.__name__}:{mode}"


FAMILIES = [
    Family("fsrgan", FSRGANTail, 32, tail_ops.prepare_tail,
           tail_ops.fused_tail_u8, tail_ops.fused_tail_u8_reference,
           tail_ops.fused_tail_canvas, tail_ops.fused_tail_canvas_reference,
           tail_ops.launch_counts, ke.build_fsrgan_kernel_engine,
           ke.prepare_fsrgan_engine, "denoise_gan_tpu_torch/csrc/tail.cu",
           "denoise_gan_tpu/ops/pallas/tail.py:290", 1.0, 0.5),
    Family("srgan", SRGANTail, 64, tail_srgan.prepare_tail64,
           tail_srgan.fused_tail64_u8, tail_srgan.fused_tail64_u8_reference,
           tail_srgan.fused_tail64_canvas,
           tail_srgan.fused_tail64_canvas_reference,
           tail_srgan.launch_counts, ke.build_srgan_kernel_engine,
           ke.prepare_srgan_engine,
           "denoise_gan_tpu_torch/csrc/tail_srgan.cu",
           "denoise_gan_tpu/ops/pallas/tail_srgan.py:151", SRGAN_BODY_GAIN,
           1.0),
]


COUNTS = [f.counts for f in FAMILIES] + [mbconv.launch_counts,
                                         fma_peak.launch_counts,
                                         int8_chain.launch_counts,
                                         relayout.launch_counts,
                                         u8_store.launch_counts,
                                         overlap.launch_counts,
                                         dw_forms.launch_counts]


def fired() -> dict[str, int]:
    """The launch counts that are not zero."""
    return {k: v for counts in COUNTS for k, v in counts.items() if v}


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


def tail_bound(h: torch.Tensor, tw, canvas: bool) -> tuple[float, str]:
    """Bound of a tail at 1080p: h read once (bf16, or int8 in qh8), the 4K
    frame written once (u8, or bf16 canvas); per core coarse pixel, up1
    (9C x 4C multiply-adds), up2 (four 2x pixels of 9C x 4C) and the output
    conv (16 fine pixels of k*k*C x 3), each at the tensor-core rate of its
    operands' type (up1 int8 only in qh8)."""
    c = tw.cin
    k2 = tw.w3.numel() // 3 // c                 # the output conv's k*k
    px = HEIGHT * WIDTH
    n_bytes = h.numel() * h.element_size() + 16 * px * 3 * (2 if canvas
                                                            else 1)
    up1, rest = 2 * px * 36 * c * c, 2 * px * (144 * c * c + 48 * k2 * c)
    return bound(n_bytes, [
        (up1, INT8_OP_S if tw.qh8 else BF16_FLOP_S),
        (rest, INT8_OP_S if tw.q8 else BF16_FLOP_S)])


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


def flax_tree(model: torch.nn.Module, draw: Callable):
    """Flax-layout (params, batch_stats) trees for `model`, each leaf drawn
    by draw(path, leaf, shape), conv kernels in HWIO."""
    params, stats = {}, {}
    for name, t in model.state_dict().items():
        *path, leaf = name.split(".")
        shape = tuple(t.shape)
        if leaf == "weight":
            o, i, kh, kw = shape
            leaf, shape = "kernel", (kh, kw, i, o)
        a = draw(path, leaf, shape)
        tree = stats if leaf in ("mean", "var") else params
        for p in path:
            tree = tree.setdefault(p, {})
        tree[leaf] = np.asarray(a, np.float32)
    return params, stats


def seeded_flax_tree(model: torch.nn.Module, rng: np.random.Generator,
                     body_gain: float = 1.0, out_gain: float = 0.5):
    """Flax-layout trees for `model` from numpy: LeCun-normal kernels,
    small biases, BN statistics near identity, PReLU slopes in [0.05, 0.3].
    Body kernels after the stem are scaled by body_gain, and the output
    conv by out_gain, so that tanh stays out of saturation and the frame is
    not flat."""
    def draw(path, leaf, shape):
        if leaf == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:3]))
            if path[-1] == "out_conv":
                a *= out_gain
            elif path[0] == "body" and path[-1] != "Conv_0":
                a *= body_gain
            return a
        if leaf == "alpha":
            return rng.uniform(0.05, 0.3, shape)
        if leaf == "scale":
            return rng.uniform(0.8, 1.2, shape)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, shape)
        return rng.standard_normal(shape) * 0.05    # conv/BN bias, BN mean

    return flax_tree(model, draw)


def jax_init_tree(model: torch.nn.Module, rng: np.random.Generator,
                  family: str):
    """Flax-layout trees for `model` drawn with numpy from the JAX
    package's own initialisers (denoise_gan_tpu/models/layers.py,
    srgan.py), the weights that tools/exp_q8_exact.py scores: FSRGAN
    kernels glorot-uniform; SRGAN kernels N(0, 0.02) and BN scales
    N(1, 0.02); every other BN scale and variance 1; biases, BN means and
    PReLU slopes 0."""
    def draw(path, leaf, shape):
        if leaf == "kernel":
            if family == "srgan":
                return rng.standard_normal(shape) * 0.02
            kh, kw, i, o = shape
            limit = np.sqrt(6.0 / ((i + o) * kh * kw))
            return rng.uniform(-limit, limit, shape)
        if leaf == "scale" and family == "srgan":
            return 1.0 + rng.standard_normal(shape) * 0.02
        return np.ones(shape) if leaf in ("scale", "var") else np.zeros(shape)

    return flax_tree(model, draw)


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


def structured_frame(height: int, width: int) -> np.ndarray:
    """High-contrast structured frame: smooth gradients, saturated blocks
    and a hard edge (tools/exp_q8_exact.py:32-44)."""
    y = np.linspace(0, 1, height, dtype=np.float32)[:, None]
    x = np.linspace(0, 1, width, dtype=np.float32)[None, :]
    r = y * np.ones_like(x)
    g = np.ones_like(y) * x
    b = 0.5 + 0.5 * np.sin(12.0 * np.pi * (x + y))
    im = np.stack([r, g, b], axis=-1)
    im[: height // 4, : width // 4] = 1.0            # saturated white block
    im[-height // 4:, -width // 4:] = 0.0            # black block
    im[height // 2:, : width // 2, 0] = 1.0          # hard red edge
    return im.astype(np.float32)


def u8_diff(a: torch.Tensor, b: torch.Tensor) -> tuple[int, float]:
    d = (a.int() - b.int()).abs()
    return int(d.max()), float((d > 0).float().mean())


def check_bound(what: str, a: torch.Tensor, b: torch.Tensor,
                exact: bool = False, target: bool = False) -> int:
    """Kernel vs twin u8: within MAX_DIFF on < MAX_FRAC, and (exact) equal;
    with `target`, says whether they are equal."""
    dmax, frac = u8_diff(a, b)
    held = f", bit-identical target {'held' if not dmax else 'missed'}" \
        if target else ""
    print(f"  {what}: max |du8| {dmax}, bytes differing {frac:.3e}{held}")
    if dmax > MAX_DIFF or frac >= MAX_FRAC or (exact and dmax):
        raise AssertionError(f"{what}: kernel and twin disagree (max "
                             f"{dmax}, fraction {frac:.3e})")
    return dmax


def check_canvas(what: str, a: torch.Tensor, b: torch.Tensor,
                 target: bool) -> float:
    """Kernel vs twin canvas (bf16 tanh): within CANVAS_DIFF on < MAX_FRAC
    of the values (bf16 mode: < CANVAS_FRAC_BF16); with `target`, says
    whether they are equal."""
    d = (a.float() - b.float()).abs()
    dmax, frac = float(d.max()), float((d > 0).float().mean())
    held = f", bit-identical target {'held' if not dmax else 'missed'}" \
        if target else ""
    print(f"  {what}: max |d| {dmax:.3e}, values differing {frac:.3e}"
          f"{held}")
    if dmax > CANVAS_DIFF or frac >= (MAX_FRAC if target
                                      else CANVAS_FRAC_BF16):
        raise AssertionError(f"{what}: kernel and twin disagree (max "
                             f"{dmax:.3e}, fraction {frac:.3e})")
    return dmax


def timed_once(fn: Callable[[], torch.Tensor]) -> tuple[torch.Tensor, float]:
    """(fn(), its ms) by CUDA events around one run, no warm-up: for plain
    versions that run for seconds."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


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
    """Phase 3/3b: the family's kernel vs its twins on seeded h at the
    1080p main-path shapes, both epilogues, every mode.  Returns (the
    tails' input by mode, grid, tail weights by mode, max error by launch
    key)."""
    ny, nx, cr = ke.plan_grid(HEIGHT, WIDTH, 27)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h = (torch.randn((ny * nx, cr + 4, tail_ops.T, fam.cin), generator=gen,
                     device=dev) * 0.5).to(torch.bfloat16)
    tails = {"bf16": fam.prepare(model.tail),
             "w8a8": fam.prepare(model.tail, q8_calib=h[:16]),
             "qh8": fam.prepare(model.tail, q8_calib=h[:16], qh8=True)}
    inputs = {m: tail_ops.quantize_h(h, tw) if tw.qh8 else h
              for m, tw in tails.items()}
    print(f"phase {label} {fam.kernel.__name__} and {fam.canvas.__name__} "
          f"vs twins: h {tuple(h.shape)} bf16 (qh8: int8), grid {ny}x{nx}, "
          f"core_rows {cr}")
    errs = {}
    for mode, tw in tails.items():
        for bgr in (False, True):
            args = (inputs[mode], tw, ny, nx, HEIGHT, WIDTH, bgr)
            got = fam.kernel(*args)
            torch.cuda.synchronize()
            want = fam.twin(*args)
            torch.cuda.synchronize()
            assert got.shape == (4 * HEIGHT, 4 * WIDTH, 3)
            key = fam.key(fam.kernel, mode)
            errs[key] = max(errs.get(key, 0), check_bound(
                f"u8 {mode} {'bgr' if bgr else 'rgb'}", got, want,
                exact=mode == "w8a8", target=mode == "qh8"))
        args = (inputs[mode], tw, ny, nx, HEIGHT, WIDTH)
        got = fam.canvas(*args)
        torch.cuda.synchronize()
        want = fam.canvas_twin(*args)
        torch.cuda.synchronize()
        assert got.shape == (4 * HEIGHT, 4 * WIDTH, 3) and \
            got.dtype == torch.bfloat16
        errs[fam.key(fam.canvas, mode)] = check_canvas(
            f"canvas {mode}", got, want, target=mode != "bf16")
    return inputs, (ny, nx, cr), tails, errs


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


def same_bits(a: torch.Tensor, b: torch.Tensor) -> tuple[bool, float]:
    """(whether a and b are equal, NaN where the other is NaN, and max
    |a - b| over the elements that are finite in both)."""
    nan = torch.isnan(a)
    same = torch.equal(nan, torch.isnan(b)) and \
        torch.equal(a.masked_fill(nan, 0), b.masked_fill(nan, 0))
    fin = torch.isfinite(a) & torch.isfinite(b)
    d = (a[fin] - b[fin]).abs()
    return same, float(d.max()) if d.numel() else 0.0


def k9_vs_plain(dev) -> dict[str, float]:
    """Phase 3d, K9: the FMA and roll + FMA kernels bit-identical to their
    plain versions at the JAX probe's shape and iterations.  Returns max
    |error| by kernel."""
    x0 = fma_peak.seeded_input(dev)
    errs = {}
    for fn, plain, iters in (
            (fma_peak.fma_chain, fma_peak.fma_chain_reference, fma_peak.ITERS),
            (fma_peak.roll_fma_chain, fma_peak.roll_fma_chain_reference,
             fma_peak.ITERS // 2)):
        got = fn(x0, iters)
        torch.cuda.synchronize()
        want = plain(x0, iters)
        same, d = same_bits(got, want)
        print(f"  {fn.__name__} {tuple(x0.shape)} x {iters}: bit-identical "
              f"{'held' if same else 'missed'} (max |d| {d:.3e}, max |plain| "
              f"{float(want.abs().max()):.3e})")
        if not same or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{fn.__name__} disagrees with its plain "
                                 "version")
        errs[fn.__name__] = d
    return errs


def bf16_steps(y, w, steps: int) -> tuple[float, float]:
    """K6 bf16 from (y, w), step by step: each kernel step from the
    kernel's previous state against the plain version's step from the same
    state, within int8_chain.bf16_step_bound, rows >= 128 kept; then one
    launch of all the steps equal to them.  Returns (max |d|, the largest
    ratio of a difference to its bound)."""
    got, max_d, ratio = y, 0.0, 0.0
    for _ in range(steps):
        prev = got
        got = int8_chain.dot_chain_steps(prev, w, 1)
        want = int8_chain.dot_chain_steps_reference(prev, w, 1)
        torch.cuda.synchronize()
        d = (got.double() - want.double()).abs()
        bound = int8_chain.bf16_step_bound(prev, w, want).clamp_min(1e-300)
        max_d = max(max_d, float(d.max()))
        ratio = max(ratio, float((d[:int8_chain.NOUT] / bound).max()))
        if not bool(torch.isfinite(got).all()) or ratio > 1 or \
                not torch.equal(got[int8_chain.NOUT:], y[int8_chain.NOUT:]):
            raise AssertionError(f"K6 bf16 step disagrees with its plain "
                                 f"version (ratio to bound {ratio:.3f})")
    if not torch.equal(int8_chain.dot_chain_steps(y, w, steps), got):
        raise AssertionError(f"K6 bf16: one launch of {steps} steps differs "
                             "from its steps")
    return max_d, ratio


def k6_vs_plain(dev) -> dict[str, float]:
    """Phase 3d, K6: at each K, from the probe's initial state at the JAX
    shape (K, 3840): int8 after ITERS steps bit-identical to the float64
    plain version; bf16 for BF16_STEPS steps by bf16_steps, and the two
    chains' divergence after them (printed).  From random states: int8
    after RANDOM_STEPS steps bit-identical, bf16 by bf16_steps.  Returns max
    |error| by kernel line name."""
    errs = {}
    steps = int8_chain.ITERS
    for k in int8_chain.KS:
        got = int8_chain.dot_chain(k, steps, torch.int8, device=dev)
        torch.cuda.synchronize()
        want = int8_chain.dot_chain_reference(k, steps, torch.int8,
                                              device=dev)
        y, w = int8_chain.random_state(k, torch.int8, device=dev,
                                        seed=SEED + k)
        r_got = int8_chain.dot_chain_steps(y, w, RANDOM_STEPS)
        torch.cuda.synchronize()
        r_want = int8_chain.dot_chain_steps_reference(y, w, RANDOM_STEPS)
        top = r_got[:int8_chain.NOUT]
        print(f"  dot_chain int8 K={k} (K, {int8_chain.M}): {steps} steps "
              f"bit-identical {'held' if torch.equal(got, want) else 'missed'}"
              f" (rows 0..127: {int(got[:int8_chain.NOUT].unique().numel())} "
              f"distinct values); random state, {RANDOM_STEPS} steps: "
              f"{'held' if torch.equal(r_got, r_want) else 'missed'} "
              f"({int(top.unique().numel())} distinct values, "
              f"{float((top.abs() == 127).float().mean()):.3f} at +-127)")
        if not (torch.equal(got, want) and torch.equal(r_got, r_want)):
            raise AssertionError(f"K6 int8 K={k} differs from its plain "
                                 "version")
        errs[f"dot_chain:int8:K={k}"] = 0.0
        y, w = int8_chain.initial_state(k, torch.bfloat16, device=dev)
        d, ratio = bf16_steps(y, w, BF16_STEPS)
        free = int8_chain.dot_chain(k, BF16_STEPS, torch.bfloat16, device=dev)
        ref = int8_chain.dot_chain_reference(k, BF16_STEPS, torch.bfloat16,
                                             device=dev)
        torch.cuda.synchronize()
        scale = float(ref.double().abs().max())
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        dfree = float((free.double() - ref.double()).abs().max())
        r_d, r_ratio = bf16_steps(
            *int8_chain.random_state(k, torch.bfloat16, device=dev,
                                     seed=SEED + k), BF16_STEPS)
        print(f"  dot_chain bf16 K={k}: steps 1-{BF16_STEPS} within "
              f"bf16_step_bound (max |d| {d:.3e}, {ratio:.3f} of the bound; "
              f"random state {r_ratio:.3f}); the two chains after "
              f"{BF16_STEPS} steps (printed only): max |d| {dfree:.3e} = "
              f"{dfree / ulp:.2f} bf16 ulps of max |plain| {scale:.3e}")
        errs[f"dot_chain:bf16:K={k}"] = max(d, r_d)
    return errs


def k8_bound(m: int, k: int, n: int, reps: int) -> tuple[float, str]:
    """K8's product: x and w read once (bf16), y (f32) and acc written
    once; 2 * M * K * N * reps operations at the bf16 tensor-core peak."""
    n_bytes = 2 * (m * k + k * n) + 4 * (m * n + 1)
    return bound(n_bytes, [(relayout.ops(m, k, n, reps), BF16_FLOP_S)])


def k8_vs_plain(dev) -> dict[str, float]:
    """Phase 3d, K8: the product kernel's instruction counts by cuobjdump
    (printed), then each form at each JAX shape with the probe's 64 reps
    within relayout.product_bound of its plain version per element and
    acc within relayout.acc_bound; the transpose chain at (1536, 128) x 8
    bit-identical.  Returns max |error| by kernels-line name."""
    for form, c in relayout.sass_counts().items():
        print(f"  matmul_form_kernel<{form}> SASS: {c['LDSM']} LDSM "
              f"({c['LDSM.16.MT88']} of them .trans), {c['HMMA']} HMMA")
    errs = {}
    for m, k, n in relayout.SHAPES:
        for form in relayout.FORMS:
            x, w = relayout.seeded_operands(m, k, n, form, dev)
            acc, y = relayout.matmul_form(x, w, form)
            torch.cuda.synchronize()
            want_acc, want = relayout.matmul_form_reference(x, w, form)
            yb = relayout.product_bound(x, w, form)
            d = (y.double() - want.double()).abs()
            ratio = float((d / yb.clamp_min(1e-300)).max())
            da = abs(float(acc) - float(want_acc))
            ab = relayout.acc_bound(yb, want_acc, relayout.REPS)
            b_ms, b_by = k8_bound(m, k, n, relayout.REPS)
            print(f"  matmul_form {form} {m}x{k}x{n} x {relayout.REPS}: max "
                  f"|dy| {float(d.max()):.3e} = {ratio:.4f} of the f32-order "
                  f"bound (max {float(yb.max()):.3e}); acc {float(acc)!r} vs "
                  f"{float(want_acc)!r}, |d| {da:.3e} of {ab:.3e}; bound "
                  f"{b_ms * 1e3:.2f} us ({b_by})")
            if not (bool(torch.isfinite(y).all()) and ratio <= 1 and
                    da <= ab):
                raise AssertionError(f"matmul_form {form} {m}x{k}x{n} "
                                     "disagrees with its plain version")
            errs[f"matmul_form:{form}:{m}x{k}x{n}"] = max(float(d.max()), da)
    x = relayout.seeded_block(dev)
    got = relayout.transpose_chain(x)
    torch.cuda.synchronize()
    same, d = same_bits(got, relayout.transpose_chain_reference(x))
    print(f"  transpose_chain {tuple(x.shape)} x {relayout.TK_ITERS}: "
          f"bit-identical {'held' if same else 'missed'} (max |d| {d:.3e})")
    if not same:
        raise AssertionError("transpose_chain disagrees with its plain "
                             "version")
    errs["transpose_chain"] = d
    return errs


def k10_vs_plain(dev) -> dict[str, float]:
    """Phase 3d, K10: the u8 store bit-identical to its plain version at
    the JAX probe's (1024, 48) and at a 4K frame's (518400, 48).  Returns
    max |error| (u8 levels) by kernels-line name."""
    d_max = 0
    for res in (u8_store.seeded_input(dev), u8_store.frame_input(dev, SEED)):
        got = u8_store.u8_phase_store(res)
        torch.cuda.synchronize()
        want = u8_store.u8_phase_store_reference(res)
        d = (got.int() - want.int()).abs()
        same = torch.equal(got, want)
        print(f"  u8_phase_store {tuple(res.shape)} -> {tuple(got.shape)}: "
              f"bit-identical {'held' if same else 'missed'} (max "
              f"{int(d.max())}, {float((d > 0).float().mean()):.2e} of the "
              f"bytes differ; {int(got.unique().numel())} distinct values)")
        if not same:
            raise AssertionError("u8_phase_store disagrees with its plain "
                                 "version")
        d_max = max(d_max, int(d.max()))
    return {"u8_phase_store": float(d_max)}


def k7_vs_plain(dev) -> tuple[dict[str, float], dict[str, float]]:
    """Phase 3d, K7: the kernel's loops in SASS by cuobjdump (printed; the
    loop of mode both must hold HMMA and SHFL); modes mxu and both for
    K7_STEPS single steps, each from the kernel's previous state, y's
    columns 0..127 within overlap.step_bound of the plain version's step,
    columns 128.. unchanged and z bit-identical, then one launch of the
    K7_STEPS steps equal to them; each mode at the JAX counts, z
    bit-identical to the plain version (timed once) and y's unchanging part
    kept.  Returns (max |error| by kernels-line name, the plain versions'
    ms at the JAX counts)."""
    loops = overlap.sass_loop_counts()
    if not loops:
        raise AssertionError("cuobjdump read no overlap_kernel from the "
                             "built library")
    for key, found in loops.items():
        print(f"  overlap_kernel<{key}> SASS loops with HMMA or SHFL: "
              + "; ".join(", ".join(f"{k} {v}" for k, v in c.items())
                          for c in found))
    if not any(c["HMMA"] and c["SHFL"]
                         for c in loops.get("both", [])):
        raise AssertionError("overlap_kernel<both> has no loop holding "
                             "both HMMA and SHFL")
    y0, z0, w = overlap.initial_state(dev)
    errs, plain_ms = {}, {}
    for mi, vi in ((1, 0), (1, 1)):
        name = f"overlap_chain:{overlap.mode(mi, vi)}"
        y, z, ratio, dmax = y0, z0, 0.0, 0.0
        for _ in range(K7_STEPS):
            gy, gz, _ = overlap.overlap_chain(y, z, w, mi, vi)
            torch.cuda.synchronize()
            wy, wz, _ = overlap.overlap_chain_reference(y, z, w, mi, vi)
            d = (gy[:, :overlap.ROWS].double()
                 - wy[:, :overlap.ROWS].double()).abs()
            b = overlap.step_bound(y, w, wy).clamp_min(1e-300)
            ratio = max(ratio, float((d / b).max()))
            dmax = max(dmax, float(d.max()))
            if not (bool(torch.isfinite(gy).all()) and ratio <= 1 and
                    torch.equal(gy[:, overlap.ROWS:], y0[:, overlap.ROWS:])
                    and torch.equal(gz, wz)):
                raise AssertionError(f"{name} step disagrees with its plain "
                                     f"version (ratio to bound {ratio:.3f})")
            y, z = gy, gz
        one = overlap.overlap_chain(y0, z0, w, K7_STEPS * mi, K7_STEPS * vi)
        if not (torch.equal(one[0], y) and torch.equal(one[1], z)):
            raise AssertionError(f"{name}: one launch of {K7_STEPS} steps "
                                 "differs from its steps")
        print(f"  {name} steps 1-{K7_STEPS}: y within step_bound (max |d| "
              f"{dmax:.3e}, {ratio:.3f} of the bound), z bit-identical; one "
              f"launch equal to the steps")
        errs[name] = dmax
    for mi, vi in ((overlap.MXU_ITERS, 0), (0, overlap.VPU_ITERS),
                   (overlap.MXU_ITERS, overlap.VPU_ITERS)):
        name = f"overlap_chain:{overlap.mode(mi, vi)}"
        gy, gz, _ = overlap.overlap_chain(y0, z0, w, mi, vi)
        (wy, wz, _), plain_ms[name] = timed_once(
            lambda: overlap.overlap_chain_reference(y0, z0, w, mi, vi))
        same, dz = same_bits(gz, wz)
        kept = torch.equal(gy[:, overlap.ROWS:], y0[:, overlap.ROWS:]) \
            and (bool(mi) or torch.equal(gy, y0))
        nan = float(torch.isnan(gy[:, :overlap.ROWS].float()).float().mean())
        print(f"  {name} ({mi}, {vi}): z bit-identical "
              f"{'held' if same else 'missed'} (max |d| {dz:.3e}); y "
              f"columns 128.. kept {'held' if kept else 'missed'}; "
              f"{nan:.3f} of y[:, 0:128] NaN (plain "
              f"{float(torch.isnan(wy[:, :overlap.ROWS].float()).float().mean()):.3f})")
        if not (same and kept):
            raise AssertionError(f"{name} at ({mi}, {vi}) disagrees with its "
                                 "plain version")
        errs[name] = max(errs.get(name, 0.0), dz)
    return errs, plain_ms


def k4_vs_plain(dev) -> tuple[dict[str, float], dict[str, float]]:
    """Phase 3d, K4: every form at the JAX shape bit-identical (e and d) to
    its plain version at K4_REPS reps and at dw_forms.REPS; chunked differs
    from scratch after one rep exactly at columns 0 and 127 of every output
    chunk.  The plain version has two functions, the flat rolls of scratch,
    value and planes and chunked's rolls within a chunk, each run (and
    timed) once at dw_forms.REPS for the forms that share it.  Returns (max
    |error| by kernels-line name, the plain versions' ms at dw_forms.REPS)."""
    e, w = dw_forms.initial_state(dev)
    errs, plain_ms, first, plain = {}, {}, {}, {}
    for form in dw_forms.FORMS:
        name = f"dw_chain:{form}"
        fn = "chunked" if form == "chunked" else "flat"
        for reps in K4_REPS + (dw_forms.REPS,):
            ge, gd = dw_forms.dw_chain(e, w, reps, form)
            torch.cuda.synchronize()
            if (fn, reps) not in plain:
                plain[fn, reps] = timed_once(
                    lambda: dw_forms.dw_chain_reference(e, w, reps, form))
            (we, wd), p_ms = plain[fn, reps]
            same = torch.equal(ge, we) and torch.equal(gd, wd)
            d = float((gd - wd).abs().max())
            if reps == 1:
                first[form] = gd
            print(f"  {name} ({e.shape[0]}, {dw_forms.MB}) x {reps}: "
                  f"bit-identical {'held' if same else 'missed'} (max |d| "
                  f"{d:.3e}, max |plain| {float(wd.abs().max()):.3e})")
            if not same:
                raise AssertionError(f"{name} x {reps} disagrees with its "
                                     "plain version")
            errs[name] = max(errs.get(name, 0.0), d)
        plain_ms[name] = p_ms
    diff = (first["chunked"] != first["scratch"]).reshape(
        e.shape[0], -1, dw_forms.CHUNK)
    cols = torch.nonzero(diff.any(0).any(0)).flatten().tolist()
    print(f"  chunked vs scratch after one rep: differ at chunk columns "
          f"{cols}, on {float(diff[..., [0, -1]].float().mean()):.3f} of "
          f"those")
    if cols != [0, dw_forms.CHUNK - 1]:
        raise AssertionError("chunked differs from scratch elsewhere than "
                             "at its chunks' edge columns")
    return errs, plain_ms


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
    launches = fired()
    print(f"phase 4c fsrgan engine, K3 body: {MAIN_FRAMES} frames "
          f"{HEIGHT}x{WIDTH} -> {tuple(outs[0].shape)} {outs[0].dtype} on "
          f"{outs[0].device}; launches {launches}")
    want = {"fused_mbconv": 6 * MAIN_FRAMES,
            "fused_tail_u8:w8a8": MAIN_FRAMES}
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
    k_ms = card.cuda_ms(lambda: [mbconv.fused_mbconv(x, w) for w in blocks],
                        reps)
    p_ms = card.cuda_ms(lambda: [mbconv.fused_mbconv_reference(x, w)
                            for w in blocks], 1)
    body = ke.prepare_fsrgan_engine(model, HEIGHT, WIDTH)[0]
    xc = x.permute(0, 3, 1, 2)
    mods = [getattr(body, f"InvertedResidual_{i}") for i in range(len(blocks))]
    with torch.inference_mode():
        lib_ms = card.cuda_ms(lambda: [m(xc) for m in mods], reps)
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


def drive(what: str, engine, frames, n: int, want: dict[str, int]):
    """One main path: `engine` on n alternating frames, every launch count
    zeroed just before and read just after; the counts must be `want`.
    Returns (the outputs, the launch counts read)."""
    reset_counts()
    outs = [engine(frames[i % 2]) for i in range(n)]
    torch.cuda.synchronize()
    launches = fired()
    print(f"  {what}: {n} frames {HEIGHT}x{WIDTH} -> {tuple(outs[0].shape)} "
          f"{outs[0].dtype} on {outs[0].device}; launches {launches}")
    if launches != want:
        raise AssertionError(f"{what} did not launch {want} and nothing "
                             f"else: {launches}")
    return outs, launches


def main_paths(label: str, fam: Family, model, frames) -> dict[str, int]:
    """Phase 4/4b: the family's engine, as a user builds it, in each mode
    and epilogue; every launch count is zeroed just before each run and
    read just after.  Returns the launches by key."""
    print(f"phase {label} {fam.name} engine, main paths:")
    calib = dict(q8_calib_frame=frames[0])
    launches, outs = {}, {}
    for mode, kw in (("w8a8", calib), ("qh8", dict(calib, qh8=True)),
                     ("bf16", {})):
        key = fam.key(fam.kernel, mode)
        engine = fam.build(model, HEIGHT, WIDTH, **kw)
        outs[mode], counted = drive(f"{mode} u8 engine", engine, frames,
                                   MAIN_FRAMES, {key: MAIN_FRAMES})
        check_frames(outs[mode])
        launches[key] = counted[key]
    d = (outs["qh8"][1].int() - outs["w8a8"][1].int()).abs()
    print(f"  qh8 vs w8a8 engine (reported here; the JAX package's qh8 "
          f"envelope, max 2, > 1 on < 5e-3, is asserted in phase 4d on the "
          f"JAX package's initialisation): max |du8| {int(d.max())}, > 0 on "
          f"{float((d > 0).float().mean()):.3e}, > 1 on "
          f"{float((d > 1).float().mean()):.3e}")
    key = fam.key(fam.canvas, "w8a8")
    engine = fam.build(model, HEIGHT, WIDTH, out_uint8=False, **calib)
    (f32,), counted = drive("w8a8 float-output engine (canvas)", engine,
                           frames[1:], 1, {key: 1})
    launches[key] = counted[key]
    lo, hi = float(f32.min()), float(f32.max())
    print(f"  float output {tuple(f32.shape)} {f32.dtype} in [{lo:.4f}, "
          f"{hi:.4f}]")
    if f32.shape != (4 * HEIGHT, 4 * WIDTH, 3) or \
            f32.dtype != torch.float32 or lo < 0 or hi > 1:
        raise AssertionError("bad float-output engine frame")
    check_bound("float engine's trunc(x*255 + 0.5) vs u8 engine",
                (f32 * 255.0 + 0.5).to(torch.uint8), outs["w8a8"][1])
    return launches


def engine_pair(fam: Family, model, frames, qh8: bool = False):
    """The engine (w8a8, or qh8) with the kernel tail and with the twin
    tail, on one calibration; the two agree within the kernel-vs-twin
    bound (w8a8: bit-identical; qh8: the target)."""
    body, tw, brc = fam.prepare_engine(model, HEIGHT, WIDTH,
                                       q8_calib_frame=frames[0], qh8=qh8)
    k_eng = ke.build_kernel_engine(body, tw, HEIGHT, WIDTH, brc=brc,
                                   tail_fn=fam.kernel)
    t_eng = ke.build_kernel_engine(body, tw, HEIGHT, WIDTH, brc=brc,
                                   tail_fn=fam.twin)
    k_out, t_out = k_eng(frames[1]), t_eng(frames[1])
    torch.cuda.synchronize()
    err = check_bound(f"{tw.mode} engine, kernel vs twin tail", k_out, t_out,
                      exact=not qh8, target=qh8)
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


@torch.inference_mode()
def exact_frame(fam: Family, model, frame01: torch.Tensor) -> torch.Tensor:
    """Phase 4d's exact oracle: the plain bf16 generator on the whole frame,
    edge-padded at the bottom and right to a multiple of 8 rows and 128
    columns (infer/engine.py:170-176, 204-209), then clip((y+1)/2, 0, 1)
    and trunc(x*255 + 0.5) as uint8, cropped to (4H, 4W, 3)."""
    height, width = frame01.shape[:2]
    dev = frame01.device
    gen = build_generator(fam.name, dtype=torch.bfloat16, device=dev)
    gen.load_state_dict(model.state_dict())
    rows = torch.arange(-(-height // 8) * 8, device=dev).clamp(max=height - 1)
    cols = torch.arange(-(-width // 128) * 128,
                        device=dev).clamp(max=width - 1)
    x = (frame01 * 2.0 - 1.0).index_select(0, rows).index_select(1, cols)
    y = gen(x[None])[0, :4 * height, :4 * width].float()
    return (((y + 1.0) / 2.0).clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def interior(height: int, width: int, cr: int) -> torch.Tensor:
    """(4H, 4W) mask of the fine pixels whose coarse pixel lies at least
    INTERIOR from a tile seam (every cr rows, every CORE columns) and from
    the frame border."""
    def far(n, period):
        i = torch.arange(n)
        k = i % period
        return torch.minimum(torch.minimum(k, period - 1 - k),
                             torch.minimum(i, n - 1 - i)) >= INTERIOR

    m = far(height, cr)[:, None] & far(width, tail_ops.CORE)[None, :]
    return m.repeat_interleave(4, 0).repeat_interleave(4, 1)


def quality_rule(fam: Family, model, height: int, width: int, dev,
                 weights: str, holds: bool) -> None:
    """Phase 4d for one family and one weight set: every engine mode against
    the exact whole-frame output on the noise and the structured frame (the
    int8 modes calibrated on the noise frame), over the whole frame and its
    interior; prints the rule of tools/exp_q8_exact.py and the qh8 engine
    against the w8a8 engine, and asserts the bf16 engine on the interior,
    and with `holds` the rule and the qh8 envelope (see the module
    docstring)."""
    rng = np.random.default_rng(SEED)
    noise_u8 = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
    noise = torch.from_numpy(noise_u8.astype(np.float32)
                             / np.float32(255.0)).to(dev)
    frames = {"noise": noise,
              "scene change": torch.from_numpy(
                  structured_frame(height, width)).to(dev)}
    brc = 27                        # every mode on the same grid
    inside = interior(height, width, ke.plan_grid(height, width, brc)[2])
    inside = inside.to(dev)
    calib = dict(q8_calib_frame=noise)

    def build(**kw):
        return fam.build(model, height, width, brc=brc, **kw)

    engines = {"bf16": build(), "w8a8": build(**calib),
               "qh8": build(qh8=True, **calib)}
    if fam.name == "fsrgan":
        body, tw, _ = ke.prepare_mbconv_fsrgan_engine(
            model, height, width, brc=brc, q8_calib_frame=noise)
        engines["K3-body w8a8"] = ke.build_kernel_engine(
            body, tw, height, width, brc=brc)
    rows, inner, outs = {}, {}, {}
    failed = []

    def score(label, got, exact):
        outs[label] = got
        d = (got.int() - exact.int()).abs()
        rows[label] = (int(d.max()), float((d > 0).float().mean()),
                       float((d > 1).float().mean()))
        di = d[inside]
        inner[label] = (int(di.max()), float((di > 1).float().mean()))
        print(f"  {fam.name} {weights} kernel[{label}] vs exact: "
              f"max={rows[label][0]} frac>0={rows[label][1]:.5f} "
              f"frac>1={rows[label][2]:.5f}; interior "
              f"({float(inside.float().mean()):.3f} of the frame) "
              f"max={inner[label][0]} frac>1={inner[label][1]:.5f}")

    for fname, frame in frames.items():
        exact = exact_frame(fam, model, frame)
        for mode, engine in engines.items():
            score(f"{mode} {fname}", engine(frame), exact)
        if fname == "noise":
            eng = build(u8_input=True, bgr_input=True, bgr=True, **calib)
            bgr_u8 = torch.from_numpy(
                np.ascontiguousarray(noise_u8[..., ::-1])).to(dev)
            score("u8q8-bgr noise", eng(bgr_u8), exact.flip(-1))
    for fname in frames:
        r = {m: rows[f"{m} {fname}"] for m in ("bf16", "w8a8", "qh8")}
        q = [rows[k] for k in rows if k.endswith(fname)
             and k.split()[0] in ("w8a8", "qh8", "u8q8-bgr")]
        w8_pp = 100 * (r["w8a8"][2] - r["bf16"][2])
        qh8_pp = 100 * (r["qh8"][2] - r["w8a8"][2])
        d = (outs[f"qh8 {fname}"].int() - outs[f"w8a8 {fname}"].int()).abs()
        dq, fq = int(d.max()), float((d > 1).float().mean())
        for what, ok in (
                (f"w8a8 frac>1 - bf16's = {w8_pp:+.3f} pp (<= 0.1)",
                 w8_pp <= 0.1),
                (f"qh8 frac>1 - w8a8's = {qh8_pp:+.3f} pp (<= 0.1)",
                 qh8_pp <= 0.1),
                (f"int8 modes' max {max(v[0] for v in q)} <= bf16's "
                 f"{r['bf16'][0]} + 2", all(v[0] <= r["bf16"][0] + 2
                                            for v in q)),
                (f"qh8 vs w8a8 engine max {dq} <= 2, > 1 on {fq:.2e} "
                 f"(< 5e-3)", dq <= 2 and fq < 5e-3)):
            print(f"  rule, {fam.name} {weights} {fname}: {what}: "
                  f"{'held' if ok else 'not held'}")
            if holds and not ok:
                failed.append(f"{fname}: {what}")
        b = inner[f"bf16 {fname}"]
        if b[0] > 2 or b[1] >= 1e-3:
            failed.append(f"{fname}: the bf16 engine is off the whole-frame "
                          f"output inside its tiles (max {b[0]}, > 1 on "
                          f"{b[1]:.3e})")
    if failed:
        raise AssertionError(f"{fam.name} {weights}: " + "; ".join(failed))


def times(fam: Family, model, frames, inputs, grid, tails, body,
          k_eng, t_eng) -> dict[str, tuple[float, float | None]]:
    """Phase 5 for one family; returns {launch key: (kernel ms, twin ms or
    None)} for each epilogue and mode."""
    ny, nx, cr = grid
    twin_reps = 1 if fam.cin > 32 else 3
    fps_k = engine_fps(k_eng, frames, TIMED_FRAMES)
    fps_t = engine_fps(t_eng, frames, twin_reps)
    q_eng = fam.build(model, HEIGHT, WIDTH, q8_calib_frame=frames[0],
                      qh8=True)
    fps_q = engine_fps(q_eng, frames, TIMED_FRAMES)
    print(f"  {fam.name} engine 1080p->4K: w8a8 kernel tail {fps_k:.2f} "
          f"frames/s, twin tail {fps_t:.2f} frames/s; qh8 kernel tail "
          f"{fps_q:.2f} frames/s")
    tiles = ke._tiles(frames[1], ny, nx, cr)
    with torch.inference_mode():
        body_ms = card.cuda_ms(lambda: body(tiles), 5)
    h = inputs["bf16"]
    q_ms = card.cuda_ms(lambda: tail_ops.quantize_h(h, tails["qh8"]), 10)
    print(f"  {fam.name} body (bf16, {ny * nx} tiles): {body_ms:.2f} "
          f"ms/frame; quantize_h (plain PyTorch): {q_ms:.2f} ms/frame")
    ms = {}
    for mode, tw in tails.items():
        args = (inputs[mode], tw, ny, nx, HEIGHT, WIDTH)
        for kernel, twin in ((fam.kernel, fam.twin),
                             (fam.canvas, fam.canvas_twin)):
            key = fam.key(kernel, mode)
            k_ms = card.cuda_ms(lambda: kernel(*args), 10)
            # the twins are slow; time those of the kernels line's entries
            t_ms = card.cuda_ms(lambda: twin(*args), twin_reps) \
                if kernel is fam.kernel or mode == "w8a8" else None
            ms[key] = (k_ms, t_ms)
            print(f"  {fam.name} tail {key}: kernel {k_ms:.2f} ms/frame"
                  + ("" if t_ms is None else f", twin {t_ms:.2f} ms/frame"))
    # The twin is built to be exact, not fast; the bf16 tail module on
    # cuDNN (per tile, without crop-stitch or u8) shows what a library tail
    # costs.
    cudnn_tail = fam.tail_cls(dtype=torch.bfloat16).to(h.device).eval()
    cudnn_tail.load_state_dict(model.tail.state_dict())
    with torch.inference_mode():
        cudnn_ms = card.cuda_ms(lambda: cudnn_tail(h), 3)
    print(f"  {fam.name} tail, bf16 {fam.tail_cls.__name__} module on cuDNN "
          f"(no crop, no u8): {cudnn_ms:.2f} ms/frame")
    return ms


def probe_times(dev, smi: str, errs: dict[str, float]) -> list[dict]:
    """Phase 5 for the probes: K9 at the JAX shape with the probe's and
    with LONG_ITERS iterations, and the roll chain on WIDE_ROWS rows (ms
    per launch over 32 chained launches, as the JAX probe's
    time_chained), its plain versions, and the FP32 peak from
    clocks.max.sm; cuBLAS at the JAX probe's matmul shapes; K6 per K
    and type (ITERS steps), its plain version, one step's product by
    torch.matmul / torch._int_mm, and the chain through them
    (library_ms).  Returns the kernels line's entries: K9 at LONG_ITERS,
    where the kernel's time is measured rather than the wrapper's, and
    K6; all with launches 0: no frame path runs the probes."""
    peak, sms, mhz = card.fp32_peak(dev)
    print(f"  FP32 peak {peak / 1e12:.2f} TF/s = {sms} SMs x "
          f"{card.FP32_LANES} lanes x 2 x {mhz:.0f} MHz (clocks.max.sm) "
          f"[{smi}]")
    x0 = fma_peak.seeded_input(dev)
    plain = {"fma_chain": fma_peak.fma_chain_reference,
             "roll_fma_chain": fma_peak.roll_fma_chain_reference}
    entries = []
    for r in fma_peak.measure(dev):
        n_bytes = 2 * 4 * r["shape"][0] * r["shape"][1]
        b_ms, b_by = bound(n_bytes, [(r["flops"], peak)])
        print(f"  {r['name']} {r['shape']} x {r['iters']}: "
              f"{r['ms']:.4f} ms, {r['tflops']:.2f} TF/s "
              f"({100 * r['tflops'] * 1e12 / peak:.1f}% of the FP32 peak), "
              f"bound {b_ms:.4f} ms ({b_by})")
        fn = plain[r["name"]]
        if not r["long"]:
            p_ms = card.time_chained(
                lambda x, fn=fn, n=r["iters"]: fn(x, n), x0, fma_peak.CHAINED)
            print(f"    plain version: {p_ms:.4f} ms (chained)")
        elif r["shape"] == fma_peak.SHAPE:
            kernel = getattr(fma_peak, r["name"])
            got = kernel(x0, r["iters"])
            want, p_ms = timed_once(lambda: fn(x0, r["iters"]))
            same, d = same_bits(got, want)
            print(f"    plain version: {p_ms:.2f} ms (one run); bit-identical "
                  f"{'held' if same else 'missed'}, "
                  f"{float(torch.isnan(want).float().mean()):.3f} NaN")
            if not same:
                raise AssertionError(f"{r['name']} x {r['iters']} disagrees "
                                     "with its plain version")
            entries.append({
                "name": r["name"], "route": "cuda",
                "source": "denoise_gan_tpu_torch/csrc/probe_fma.cu",
                "replaces": "tools/exp_vpu_peak.py:" + (
                    "39" if r["name"] == "fma_chain" else "49"),
                "launches": 0, "max_abs_err": max(errs[r["name"]], d),
                "ms": r["ms"], "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None})
    for r in fma_peak.matmul_yardsticks(dev):
        print(f"  torch.matmul form {r['form']} bf16 {r['m']}x{r['k']}x"
              f"{r['n']} (chained): {r['ms']:.4f} ms, {r['tflops']:.1f} TF/s")
    steps = int8_chain.ITERS
    by_k: dict[int, dict[str, float]] = {}
    for r in int8_chain.measure(dev):
        k, dtype = r["k"], r["dtype"]
        name = int8_chain.NAMES[dtype]
        y, w = int8_chain.initial_state(k, dtype, device=dev)
        p_ms = card.cuda_ms(
            lambda: int8_chain.dot_chain_steps_reference(y, w, steps), 1)
        n_bytes = (2 * y.numel() + w.numel()) * y.element_size()
        b_ms, b_by = bound(n_bytes, [(int8_chain.ops(k, steps),
                                      BF16_FLOP_S if name == "bf16"
                                      else INT8_OP_S)])
        lib, chain = r["library_step_ms"], r["library_chain_ms"]
        by_k.setdefault(k, {})[name] = r["ms"]
        print(f"  dot_chain {name} K={k} x {steps} steps: {r['ms']:.3f} ms, "
              f"{r['tops']:.1f} T/s, bound {b_ms:.3f} ms ({b_by}); plain "
              f"version {p_ms:.2f} ms; by "
              + ("torch.matmul" if name == "bf16" else "torch._int_mm")
              + (f": one step's product {lib:.4f} ms, the chain {chain:.2f} ms"
                 if lib is not None else ": refused"))
        if name == "int8" and lib is not None:
            same = torch.equal(int8_chain.library_chain(y, w, steps),
                               int8_chain.dot_chain_steps(y, w, steps))
            print(f"    the library chain bit-identical to the kernel's: "
                  f"{'held' if same else 'missed'} (printed only)")
        if len(by_k[k]) == 2:
            ratio = by_k[k]["bf16"] / by_k[k]["int8"]
            print(f"    i8/bf16 at K={k}: {ratio:.2f}x")
        entries.append({
            "name": f"dot_chain:{name}:K={k}", "route": "cuda",
            "source": "denoise_gan_tpu_torch/csrc/probe_mma.cu",
            "replaces": "tools/exp_int8_mosaic.py:" + (
                "33" if name == "bf16" else "50"),
            "launches": 0, "max_abs_err": errs[f"dot_chain:{name}:K={k}"],
            "ms": r["ms"], "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": chain})
    return entries


def k8_k10_times(dev, errs: dict[str, float]) -> list[dict]:
    """Phase 5 for K8 and K10: K8's product per form and JAX shape with the
    probe's 64 reps (the kernels line: ms, bound, the plain version and 64
    torch.matmul calls (library_ms), all at 64 reps) and with LONG_REPS
    (printed: ms, T/s, bound); the transpose chain with 8 iterations (the
    kernels line, as the product) and LONG_ITERS (printed), each with its
    bound and shared-memory floor (16 bytes an element an iteration at
    128 bytes/clock/SM); K10 at (1024, 48) and at the 4K frame's rows (the
    kernels line), its bound and its plain version.  Kernel and library
    times are queued behind a device sleep (card.queued_ms).  Returns the
    kernels line's entries, all with launches 0: no frame path runs the
    probes."""
    peak, sms, mhz = card.fp32_peak(dev)
    entries, long_ms = [], {}
    for r in relayout.measure(dev):
        long, reps = r["long"], r["reps"]
        if r["name"] == "transpose_chain":
            x = relayout.seeded_block(dev)
            n_el = x.numel()
            b_ms, b_by = bound(8 * n_el, [(n_el * reps, peak)])
            smem_ms = 16 * n_el * reps / (128 * sms * mhz * 1e6) * 1e3
            print(f"  transpose_chain {relayout.TK_SHAPE} x {reps} "
                  f"iterations: {r['ms']:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}), shared-memory floor {smem_ms:.4f} ms")
            if long:
                continue
            lib = card.queued_ms(
                lambda: relayout.library_transpose_chain(x, reps), 5)
            p_ms = card.cuda_ms(
                lambda: relayout.transpose_chain_reference(x, reps), 5)
            print(f"    x {reps}: plain version {p_ms:.4f} ms; by "
                  f".t().contiguous() and mul {lib:.4f} ms")
            entries.append({
                "name": "transpose_chain", "route": "cuda",
                "source": "denoise_gan_tpu_torch/csrc/probe_relayout.cu",
                "replaces": "tools/exp_relayout.py:119", "launches": 0,
                "max_abs_err": errs["transpose_chain"], "ms": r["ms"],
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib})
            continue
        (m, k, n), form = r["shape"], r["name"].split(":")[1]
        name = f"{r['name']}:{m}x{k}x{n}"
        b_ms, b_by = k8_bound(m, k, n, reps)
        print(f"  {name} x {reps} reps: {r['ms']:.4f} ms, {r['tops']:.1f} "
              f"T/s ({100 * r['tops'] * 1e12 / BF16_FLOP_S:.1f}% of the bf16 "
              f"peak), bound {b_ms:.4f} ms ({b_by})")
        if long:
            long_ms[name] = r["ms"]
            continue
        x, w = relayout.seeded_operands(m, k, n, form, dev)
        lib = card.queued_ms(
            lambda: relayout.library_products(x, w, form, reps), 5)
        p_ms = card.cuda_ms(
            lambda: relayout.matmul_form_reference(x, w, form, reps), 3)
        print(f"    x {reps}: plain version (float64) {p_ms:.3f} ms; "
              f"{reps} torch.matmul calls {lib:.4f} ms")
        entries.append({
            "name": name, "route": "cuda",
            "source": "denoise_gan_tpu_torch/csrc/probe_relayout.cu",
            "replaces": "tools/exp_relayout.py:41", "launches": 0,
            "max_abs_err": errs[name], "ms": r["ms"], "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
    ms = {e["name"]: e["ms"] for e in entries}
    for m, k, n in relayout.SHAPES:
        shape = f"{m}x{k}x{n}"
        for reps, by in ((relayout.REPS, ms), (relayout.LONG_REPS, long_ms)):
            ratio = by[f"matmul_form:sublane:{shape}"] \
                / by[f"matmul_form:canonical:{shape}"]
            print(f"    sublane / canonical at {shape} x {reps}: "
                  f"{ratio:.3f}")
    for r in u8_store.measure(dev):
        rows = r["rows"]
        res = u8_store.seeded_input(dev) if rows == u8_store.ROWS \
            else u8_store.frame_input(dev, SEED)
        b_ms, b_by = bound(u8_store.n_bytes(rows),
                           [(8 * res.numel(), peak)])
        p_ms = card.cuda_ms(lambda: u8_store.u8_phase_store_reference(res), 3)
        print(f"  u8_phase_store ({rows}, {u8_store.COLS}): {r['ms']:.4f} ms, "
              f"{r['gbs']:.0f} GB/s, bound {b_ms:.4f} ms ({b_by}); plain "
              f"version {p_ms:.4f} ms")
        if rows == u8_store.FRAME_4K_ROWS:
            entries.append({
                "name": "u8_phase_store", "route": "cuda",
                "source": "denoise_gan_tpu_torch/csrc/probe_u8.cu",
                "replaces": "tools/exp_u8_store.py:17", "launches": 0,
                "max_abs_err": errs["u8_phase_store"], "ms": r["ms"],
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None})
    return entries


def k7_k4_times(dev, errs: dict[str, float],
                plain_ms: dict[str, float]) -> list[dict]:
    """Phase 5 for K7 and K4.  K7: each mode's ms (CUDA events, the mean
    of overlap.TIMED launches) at the JAX counts and at equal counts
    overlap.EQUAL_ITERS, the JAX probe's comparison (its t(c) runs both
    chains 4000 times) and the one at equal counts with the overlap share;
    the chains through library calls at the JAX counts (library_ms); the
    bound per mode (the product's operations at the bf16 peak, the roll +
    FMA's at the FP32 peak, the larger of the two for both) and the roll's
    shuffle floor (one row's 15,360 shuffles an iteration on one SM at 32
    a clock).  K4: each form's ms per launch of dw_forms.REPS reps, us per
    band step against the bound (operations at the FP32 peak) and the
    shared-memory floor, scaled by the TPU geometry's 7119 band steps a
    frame, and the chain through F.conv2d(groups=192) with cuDNN's TF32
    off (library_ms).  Returns the kernels line's entries (the JAX counts;
    launches 0: no frame path runs the probes)."""
    peak, sms, mhz = card.fp32_peak(dev)
    entries = []
    ms = overlap.measure(dev)
    cmp = overlap.compare(ms)
    n = overlap.EQUAL_ITERS
    y0, z0, w = overlap.initial_state(dev)
    for mi, vi in ((overlap.MXU_ITERS, 0), (0, overlap.VPU_ITERS),
                   (overlap.MXU_ITERS, overlap.VPU_ITERS)):
        name = f"overlap_chain:{overlap.mode(mi, vi)}"
        mma_ops, fma_ops = overlap.ops(mi, vi)
        b_ms, b_by = max(bound(overlap.n_bytes(), [(mma_ops, BF16_FLOP_S)]),
                         bound(overlap.n_bytes(), [(fma_ops, peak)]))
        lib = card.cuda_ms(
            lambda: overlap.library_chain(y0, z0, w, mi, vi), 1)
        shuffle_ms = max(mi, vi) * overlap.M / 32 / (mhz * 1e3) if vi else 0
        print(f"  {name} ({mi}, {vi}): {ms[mi, vi]:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), shuffle floor {shuffle_ms:.3f} ms; "
              f"plain version {plain_ms[name]:.1f} ms; library calls "
              f"{lib:.2f} ms")
        entries.append({
            "name": name, "route": "cuda",
            "source": "denoise_gan_tpu_torch/csrc/probe_overlap.cu",
            "replaces": "tools/exp_overlap_probe.py:32", "launches": 0,
            "max_abs_err": errs[name], "ms": ms[mi, vi],
            "plain_ms": plain_ms[name], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib})
    print(f"    the JAX probe's comparison: sum {cmp['jax_sum']:.3f}, max "
          f"{cmp['jax_max']:.3f}, interleaved {cmp['jax_c']:.3f} ms")
    print(f"    equal counts n={n}: t(a) {ms[n, 0]:.3f}, t(b) {ms[0, n]:.3f}, "
          f"t(c) {cmp['c']:.3f} ms; sum {cmp['sum']:.3f}, max "
          f"{cmp['max']:.3f}; overlap share {cmp['share']:.3f} (t(c) is "
          f"set by the 8 SMs that run both chains)")
    reps = dw_forms.REPS
    times = dw_forms.measure(dev)
    lib = dw_forms.library_ms(dev)
    b_ms, b_by = bound(dw_forms.n_bytes(), [(dw_forms.ops(reps), peak)])
    for form in dw_forms.FORMS:
        name = f"dw_chain:{form}"
        us = times[form] / reps * 1e3
        floor = dw_forms.smem_floor_ms(form, sms, mhz) * 1e3
        print(f"  {name} x {reps}: {times[form]:.3f} ms, {us:.3f} us/band "
              f"step (x {dw_forms.FRAME_STEPS} band steps of the TPU "
              f"geometry: {us * dw_forms.FRAME_STEPS / 1e3:.2f} ms), bound "
              f"{b_ms / reps * 1e3:.3f} us ({b_by}), shared-memory floor "
              f"{floor:.3f} us; plain version {plain_ms[name]:.1f} ms; "
              f"F.conv2d chain (TF32 off) {lib[form]:.2f} ms")
        entries.append({
            "name": name, "route": "cuda",
            "source": "denoise_gan_tpu_torch/csrc/probe_dw.cu",
            "replaces": "tools/exp_dw_forms.py:96", "launches": 0,
            "max_abs_err": errs[name], "ms": times[form],
            "plain_ms": plain_ms[name], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib[form]})
    return entries


def main() -> None:
    # ---- phase 1: device
    dev = require_cuda()
    smi = card.smi("name,power.limit", dev.index or 0)
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
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(SEED)
    models = {f.name: seeded_model(f, rng, dev) for f in FAMILIES}

    # ---- phase 3 / 3b / 3c: kernels vs twins at the main-path shapes
    checked = {f.name: kernel_vs_twin(label, f, models[f.name], dev)
               for label, f in zip(("3", "3b"), FAMILIES)}
    x3, blocks3, err3, exact3 = k3_vs_plain(models["fsrgan"], dev)
    # ---- phase 3d: the probes' kernels vs their plain versions
    print("phase 3d probes vs plain versions (K9 at (512, 1024), K6 at "
          f"(K, {int8_chain.M}), K8, K10, K7 and K4 at the JAX shapes, K10 "
          "also at a 4K frame):")
    probe_errs = {**k9_vs_plain(dev), **k6_vs_plain(dev), **k8_vs_plain(dev),
                  **k10_vs_plain(dev)}
    k7_errs, k7_plain = k7_vs_plain(dev)
    k4_errs, k4_plain = k4_vs_plain(dev)

    # ---- phase 4 / 4b: the main paths, 1080p -> 4K
    frames = [seeded_frame(rng, HEIGHT, WIDTH, dev) for _ in range(2)]
    launches, pairs, errs = {}, {}, {}
    for label, fam in zip(("4", "4b"), FAMILIES):
        model = models[fam.name]
        launches.update(main_paths(label, fam, model, frames))
        pairs[fam.name] = engine_pair(fam, model, frames)
        errs.update(checked[fam.name][3])
        key = fam.key(fam.kernel, "w8a8")
        errs[key] = max(errs[key], pairs[fam.name][3])
        key = fam.key(fam.kernel, "qh8")
        errs[key] = max(errs[key],
                        engine_pair(fam, model, frames, qh8=True)[3])
        if fam.name == "fsrgan":
            check_plain_tail(model, rng, dev)
        else:
            check_input_options(fam, model, frames)
    # ---- phase 4c: the FSRGAN engine with the K3 body
    launches3, k3_eng, plain_eng = k3_main_path(models["fsrgan"], frames,
                                                exact3)
    # ---- phase 4d: the whole-frame quality rule
    print(f"phase 4d whole-frame quality rule ({HEIGHT}x{WIDTH}, u8 levels "
          "vs the plain bf16 generator on the whole frame):")
    for fam in FAMILIES:
        quality_rule(fam, models[fam.name], HEIGHT, WIDTH, dev, "seeded",
                     holds=False)
        model = build_generator(fam.name, device=dev)
        model = from_jax_params(model, *jax_init_tree(
            model, np.random.default_rng(SEED), fam.name))
        quality_rule(fam, model, HEIGHT, WIDTH, dev, "JAX-init", holds=True)

    # ---- phase 5: times
    print(f"phase 5 times [{smi}]:")
    ms = {}
    for fam in FAMILIES:
        inputs, grid, tails, _ = checked[fam.name]
        body, k_eng, t_eng, _ = pairs[fam.name]
        ms.update(times(fam, models[fam.name], frames, inputs, grid, tails,
                        body, k_eng, t_eng))

    k3 = k3_times(models["fsrgan"], frames, x3, blocks3, k3_eng, plain_eng)
    probes = probe_times(dev, smi, probe_errs) + k8_k10_times(
        dev, probe_errs) + k7_k4_times(dev, {**k7_errs, **k4_errs},
                                       {**k7_plain, **k4_plain})

    kernels = []
    for fam in FAMILIES:
        inputs, _, tails, _ = checked[fam.name]
        for key in [fam.key(fam.kernel, m) for m in MODES] + \
                [fam.key(fam.canvas, "w8a8")]:
            mode = key.split(":")[1]
            b_ms, b_by = tail_bound(inputs[mode], tails[mode],
                                    canvas=key.startswith(
                                        fam.canvas.__name__))
            print(f"  {key} bound {b_ms:.3f} ms/frame ({b_by})")
            kernels.append({
                "name": key, "route": "cuda", "source": fam.source,
                "replaces": fam.replaces, "launches": launches[key],
                "max_abs_err": errs[key], "ms": ms[key][0],
                "plain_ms": ms[key][1], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None})
    kernels.append({
        "name": "fused_mbconv", "route": "cuda",
        "source": "denoise_gan_tpu_torch/csrc/mbconv.cu",
        "replaces": "tools/exp_mbconv_kernel.py:37",
        "launches": launches3["fused_mbconv"], "max_abs_err": err3,
        "ms": k3[0], "plain_ms": k3[1], "bound_ms": k3[3],
        "bound_by": k3[4], "library_ms": None})
    record = {"kernels": kernels + probes}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
