"""Tensor-core chained-dot probe (K6): bf16 vs int8 chains of dependent
products at the tails' contraction depths.

Counterpart of tools/exp_int8_mosaic.py, which asked whether int8 doubles
the TPU matrix unit's rate.  Its state is y (K, M) and w (K, 128), built
from iotas (``initial_state``); a step computes s = w^T . y (128 x M) and
writes it over y's rows 0..127:

* bf16: s summed in f32, rounded to bf16;
* int8: s summed in int32, then ``clip(s >> 8, -127, 127)``, ``>>`` an
  arithmetic shift (floor division by 256).

Rows 128..K-1 never change.  ``dot_chain_steps`` launches the CUDA kernel
of csrc/probe_mma.cu (``mma.sync``); on tensors that lie on the CPU it runs
the plain version, ``dot_chain_steps_reference``, whose sums are exact for
int8: int64 on the CPU, float64 on the card (|s| <= K * 127 * 124, about
1.8e7 at K = 1152, is above 2**24, so float32 is not exact, and int64
matmul does not run on CUDA).  In bf16 the plain version sums in float64
and rounds to float32, an ideal f32 accumulator, then to bf16; the kernel's
f32 sums run in another order, so the two may be one bf16 rounding apart
(``bf16_step_bound``).

The bf16 chain grows about 4-5x a step and overflows to inf, then NaN,
well before step 100, so a 2000-step bf16 run times inf/NaN data, as the
TPU probe's did; tensor-core time does not depend on the data.

    python -m denoise_gan_tpu_torch.probes.int8_chain   # on a CUDA GPU

runs the JAX probe's grid, K in (128, 384, 1152), 2000 steps, bf16 and
int8, and prints ms, T/s and the int8 speedup, and beside them one step's
product and the whole chain through ``torch.matmul`` (bf16) and
``torch._int_mm`` (int8), ``library_chain``.
"""

from __future__ import annotations

import numpy as np
import torch

from denoise_gan_tpu_torch.utils import card
from denoise_gan_tpu_torch.utils.device import require_cuda, resolve_device

M = 3840                 # tools/exp_int8_mosaic.py:28
ITERS = 2000             # :29
KS = (128, 384, 1152)    # :99
NOUT = 128               # rows of s, columns of w
NAMES = {torch.bfloat16: "bf16", torch.int8: "int8"}
REPS = 6                 # timed launches after a warm-up (:80)
CHUNK = 128              # bytes of K per chunk of w in csrc/probe_mma.cu

# Plain integers: the kernel's launches, by element type.
launch_counts = {f"dot_chain_steps:{n}": 0 for n in NAMES.values()}


def initial_state(k: int, dtype: torch.dtype, m: int = M,
                  device: torch.device | str = "cuda"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (k, m), w (k, 128)) of the JAX probe (:34-37, :51-55), in dtype:
    bf16 y[r, c] = bf16(f32(c) * f32(1e-4)), w[r, n] = bf16(f32(r - n) *
    f32(1e-3)); int8 y[r, c] = c % 127, w[r, n] = (r - n) % 125 (the
    divisor's sign: 0..124)."""
    dev = resolve_device(device)
    rows = np.arange(k)[:, None]
    cols, outs = np.arange(m)[None, :], np.arange(NOUT)[None, :]
    if dtype == torch.bfloat16:
        y = np.broadcast_to(cols.astype(np.float32) * np.float32(1e-4), (k, m))
        w = (rows - outs).astype(np.float32) * np.float32(1e-3)
    elif dtype == torch.int8:
        y = np.broadcast_to(cols % 127, (k, m))
        w = (rows - outs) % 125
    else:
        raise ValueError(f"dtype must be bf16 or int8, got {dtype}")
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
                 for a in (y, w))


def random_state(k: int, dtype: torch.dtype, m: int = M,
                 device: torch.device | str = "cuda", seed: int = 0
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (k, m), w (k, 128)) drawn from ``np.random.default_rng(seed)``
    for checks that the initial state cannot make: there the int8 chain
    saturates at 127 within two steps and never goes negative.  int8: y
    uniform in [-127, 127], w in [-a, a] with a = 48 at K = 128 (every row
    is rewritten each step) and 8 * sqrt(1152 / K) above (rows >= 128 keep
    driving it), so that s >> 8 takes both signs and most values for 100
    steps, rarely at +-127 (the share measured in numpy: 0.26 at K = 128,
    under 0.01 above).  bf16: y ~ N(0, 1), w ~ N(0, 1/K)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        a = 48 if k == NOUT else max(1, round(8 * np.sqrt(1152 / k)))
        y = rng.integers(-127, 128, (k, m))
        w = rng.integers(-a, a + 1, (k, NOUT))
    elif dtype == torch.bfloat16:
        y = rng.standard_normal((k, m))
        w = rng.standard_normal((k, NOUT)) / np.sqrt(k)
    else:
        raise ValueError(f"dtype must be bf16 or int8, got {dtype}")
    return tuple(torch.from_numpy(a).to(dev, dtype) for a in (y, w))


def _check(y: torch.Tensor, w: torch.Tensor, iters: int) -> None:
    if y.dtype not in NAMES or w.dtype != y.dtype:
        raise ValueError(f"y and w must both be bf16 or int8, got {y.dtype} "
                         f"and {w.dtype}")
    if y.dim() != 2 or w.shape != (y.shape[0], NOUT) or y.shape[0] < NOUT \
            or y.shape[1] < 1:
        raise ValueError(f"y must be (K, m) and w (K, {NOUT}) with K >= "
                         f"{NOUT}, got {tuple(y.shape)} and {tuple(w.shape)}")
    if y.device != w.device:
        raise ValueError(f"y on {y.device}, w on {w.device}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


@torch.no_grad()
def dot_chain_steps_reference(y: torch.Tensor, w: torch.Tensor,
                              iters: int) -> torch.Tensor:
    """Plain version: iters steps ``y[0:128] = w^T . y`` from y (K, m) and
    w (K, 128), returned as a new y (module docstring)."""
    _check(y, w, iters)
    if y.dtype == torch.int8:
        acc = torch.int64 if y.device.type == "cpu" else torch.float64
        yy, wt = y.to(acc), w.to(acc).t()
        for _ in range(iters):
            s = torch.div(wt @ yy, 256, rounding_mode="floor")
            yy[:NOUT] = s.clamp_(-127, 127)
        return yy.to(torch.int8)
    yy, wt = y.double(), w.double().t()
    for _ in range(iters):
        yy[:NOUT] = (wt @ yy).float().bfloat16().double()
    return yy.bfloat16()


def dot_chain_steps(y: torch.Tensor, w: torch.Tensor,
                    iters: int) -> torch.Tensor:
    """The chain as one CUDA kernel launch (csrc/probe_mma.cu); same
    contract as :func:`dot_chain_steps_reference`, which runs instead when
    the tensors lie on the CPU.  Any other device launches the kernel or
    raises: it takes contiguous y (K, m) and w (K, 128) with K a multiple
    of 64 (bf16) or 128 (int8); a K too large for the kernel's shared
    memory (bf16 K > 2432, int8 K > 4864) fails at the launch."""
    _check(y, w, iters)
    if y.device.type == "cpu":
        return dot_chain_steps_reference(y, w, iters)
    require_cuda(y.device)
    k, m = y.shape
    if (k * y.element_size()) % CHUNK:
        raise ValueError(f"the kernel takes K * element size a multiple of "
                         f"{CHUNK} bytes, got K = {k} in {NAMES[y.dtype]}")
    if not y.is_contiguous() or not w.is_contiguous():
        raise ValueError("y and w must be contiguous")
    from denoise_gan_tpu_torch.ops._build import load_library

    out = y.clone()
    wt = w.t().contiguous()               # 128 x K, K-contiguous
    with torch.cuda.device(y.device):     # the launch uses the current device
        err = load_library().dgt_probe_dot_chain(
            wt.data_ptr(), out.data_ptr(), k, m, iters,
            int(y.dtype == torch.int8),
            torch.cuda.current_stream(y.device).cuda_stream)
    if err:
        raise RuntimeError(f"dgt_probe_dot_chain launch failed: CUDA error "
                           f"{err}")
    launch_counts[f"dot_chain_steps:{NAMES[y.dtype]}"] += 1
    return out


def dot_chain(k: int, iters: int, dtype: torch.dtype, m: int = M,
              device: torch.device | str = "cuda") -> torch.Tensor:
    """The JAX probe's chain: iters steps from ``initial_state(k, dtype,
    m)`` through :func:`dot_chain_steps`; the final y (k, m)."""
    return dot_chain_steps(*initial_state(k, dtype, m, device), iters)


def dot_chain_reference(k: int, iters: int, dtype: torch.dtype, m: int = M,
                        device: torch.device | str = "cuda") -> torch.Tensor:
    """:func:`dot_chain` through the plain version."""
    return dot_chain_steps_reference(*initial_state(k, dtype, m, device),
                                     iters)


def bf16_step_bound(y: torch.Tensor, w: torch.Tensor,
                    want: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |kernel - plain version| for rows 0..127 of one
    bf16 step from y, where want is the plain version's new y: one bf16
    rounding apart, 2**-7 |want|, after f32 sums in different orders, each
    within K * 2**-23 * (|w|^T |y|) of the exact sum (doubled).  float64,
    (128, m)."""
    scale = w.double().abs().t() @ y.double().abs()
    return 2.0 ** -7 * want[:NOUT].double().abs() \
        + y.shape[0] * 2.0 ** -22 * scale


def ops(k: int, iters: int, m: int = M) -> int:
    """Multiply-adds x 2 of a chain: 2 * K * 128 * m per step."""
    return 2 * k * NOUT * m * iters


def measure(device: torch.device | str = "cuda") -> list[dict]:
    """The kernel's ms per chain of ITERS steps from the initial state, for
    each K of KS and type (one warm-up, then the mean of REPS launches by
    CUDA events, copies of y and w^T included), its T/s, the ms of one
    step's product by one PyTorch call (None where it refuses the shape),
    and the ms of the whole chain through such calls (``library_chain``,
    one warm-up, then the mean of two runs)."""
    dev = require_cuda(device)
    rows = []
    for k in KS:
        for dtype in NAMES:
            y, w = initial_state(k, dtype, M, dev)
            ms = card.cuda_ms(lambda: dot_chain_steps(y, w, ITERS), REPS)
            step_ms = library_step_ms(y, w)
            chain_ms = None if step_ms is None else card.cuda_ms(
                lambda: library_chain(y, w, ITERS), 2)
            rows.append(dict(k=k, dtype=dtype, ms=ms,
                             tops=ops(k, ITERS) / ms / 1e9,
                             library_step_ms=step_ms,
                             library_chain_ms=chain_ms))
    return rows


def _library_product(wt: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """w^T . y by one PyTorch call on the card: ``torch.matmul`` in bf16
    (cuBLAS, f32 sums, bf16 out), ``torch._int_mm`` in int8 (int32 out)."""
    return torch.matmul(wt, y) if y.dtype == torch.bfloat16 \
        else torch._int_mm(wt, y)


def library_step_ms(y: torch.Tensor, w: torch.Tensor,
                    reps: int = 20) -> float | None:
    """ms of one step's product w^T . y on the card by one PyTorch call
    (``_library_product``); None where ``_int_mm`` refuses the shape."""
    wt = w.t().contiguous()
    try:
        _library_product(wt, y)
    except RuntimeError as e:
        print(f"torch._int_mm refuses {tuple(wt.shape)} x {tuple(y.shape)}: "
              f"{str(e).splitlines()[0]}")
        return None
    return card.cuda_ms(lambda: _library_product(wt, y), reps)


@torch.no_grad()
def library_chain(y: torch.Tensor, w: torch.Tensor,
                  iters: int) -> torch.Tensor:
    """The chain through PyTorch's library calls, the kernel's yardstick:
    each step ``_library_product``, then for int8 ``>> 8`` (arithmetic on
    int32), the clip and the cast, written over rows 0..127 of a copy of
    y.  Exact for int8 (|s| < 2**31); bf16 sums in cuBLAS's order."""
    _check(y, w, iters)
    yy, wt = y.clone(), w.t().contiguous()
    for _ in range(iters):
        s = _library_product(wt, yy)
        if yy.dtype == torch.int8:
            s = (s >> 8).clamp_(-127, 127).to(torch.int8)
        yy[:NOUT] = s
    return yy


def main(device: torch.device | str = "cuda") -> None:
    dev = require_cuda(device)
    print(card.smi("name,power.limit", dev.index or 0))
    by_k: dict[int, dict[str, float]] = {}
    for r in measure(dev):
        name = NAMES[r["dtype"]]
        by_k.setdefault(r["k"], {})[name] = r["ms"]
        lib, chain = r["library_step_ms"], r["library_chain_ms"]
        print(f"{name} K={r['k']} {ITERS} chained dots: {r['ms']:.3f} ms"
              f"  ({r['tops']:.0f} T/s); by "
              + ("torch.matmul" if name == "bf16" else "torch._int_mm")
              + (f": one step's product {lib:.4f} ms, the chain "
                 f"{chain:.2f} ms" if lib is not None else ": refused"))
        if len(by_k[r["k"]]) == 2:
            ms = by_k[r["k"]]
            print(f"   => i8 speedup {ms['bf16'] / ms['int8']:.2f}x")


if __name__ == "__main__":
    main()
