"""CUDA-core peak probe (K9): chained FMA and roll + FMA on f32, and cuBLAS
at the tails' matmul shapes.

Counterpart of tools/exp_vpu_peak.py, which measured the TPU vector unit's
FMA peak (``fma_kernel``), the cost of a lane roll (``roll_fma_kernel``) and
the matrix unit's rate at the tail and body shapes.  On the H100 the first
two become the CUDA cores' FFMA peak and the cost of the ``__shfl_sync`` +
FMA step that csrc/tail_srgan.cu uses to feed R: the roofline for the
ported kernels, which all run on the CUDA cores.

* ``fma_chain``: ``acc * 1.000001 + 1e-7``, ``iters`` times, per element;
* ``roll_fma_chain``: ``acc + roll(acc, 1, axis 1) * 0.999999``, ``iters``
  times, where ``roll(a, 1)[:, j] = a[:, j - 1]`` and column 0 takes the
  last column (``torch.roll``, as ``pltpu.roll``).

The wrappers launch the CUDA kernels of csrc/probe_fma.cu; on a tensor that
lies on the CPU they run the plain versions, ``fma_chain_reference`` and
``roll_fma_chain_reference``: elementwise torch ops that round each
multiply-add once, as the kernels' ``fmaf`` does (``fma_f32``), so kernel
and plain version agree bit for bit.  The roll kernel takes rows of
ROLL_WIDTH (1024) floats, the JAX probe's, and raises on any other width.

    python -m denoise_gan_tpu_torch.probes.fma_peak     # on a CUDA GPU

times 32 chained launches (as the JAX probe's ``time_chained``) at the JAX
shape (512, 1024) with 256 iterations (128 for the roll), a few microseconds
of work where launch cost dominates, and again with LONG_ITERS, where one
launch takes over a millisecond, and the roll chain on 4096 rows; then
chained ``torch.matmul`` at the JAX probe's matmul shapes in both operand
forms.
"""

from __future__ import annotations

import numpy as np
import torch

from denoise_gan_tpu_torch.utils import card
from denoise_gan_tpu_torch.utils.device import require_cuda

SHAPE = (512, 1024)          # tools/exp_vpu_peak.py:57
ITERS = 256                  # :36; the roll chain runs ITERS // 2
LONG_ITERS = 65536           # one launch of the FMA chain >= 1 ms at SHAPE
WIDE_ROWS = 4096             # 32 warps an SM for the roll chain
CHAINED = 32                 # launches per timing (time_chained, :24)
FMA_C1 = float(np.float32(1.000001))
FMA_C2 = float(np.float32(1e-7))
ROLL_C1 = float(np.float32(0.999999))
ROLL_WIDTH = SHAPE[1]         # the one width the roll kernel takes
# (M, K, N) of the JAX probe's matmul section (:84-85)
MATMUL_SHAPES = ((2560, 128, 128), (2560, 384, 128), (2560, 1152, 128),
                 (2560, 1152, 48), (8192, 512, 512))

# Plain integers: the kernels' launches.
launch_counts = {"fma_chain": 0, "roll_fma_chain": 0}


def _check(x: torch.Tensor, iters: int) -> None:
    if x.dtype != torch.float32 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


def fma_f32(a: torch.Tensor, c: float | torch.Tensor,
            b: torch.Tensor | float) -> torch.Tensor:
    """a * c + b rounded once to float32, as CUDA's ``fmaf``, for float32 a
    and b and a float32 value (or a float32 tensor that broadcasts with a)
    c.  The product is exact in float64 (24 + 24 bits); the sum is s + e
    exactly (TwoSum); s is rounded to odd (moved one float64 ulp towards e
    where e != 0 and s is even), and a value rounded to odd at 53 bits
    rounds to 24 bits as the exact sum would.  Where s is not finite it
    stands as it is."""
    p = a.double() * (c.double() if isinstance(c, torch.Tensor) else c)
    b = b.double() if isinstance(b, torch.Tensor) else float(b)
    s = p + b
    bv = s - p
    e = (p - (s - bv)) + (b - bv)
    nudge = (e != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    away = torch.nextafter(s, torch.copysign(torch.full_like(s, np.inf), e))
    return torch.where(nudge, away, s).float()


@torch.no_grad()
def fma_chain_reference(x: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version: ``acc = fma_f32(acc, FMA_C1, FMA_C2)``, iters
    times."""
    _check(x, iters)
    acc = x.clone()
    for _ in range(iters):
        acc = fma_f32(acc, FMA_C1, FMA_C2)
    return acc


@torch.no_grad()
def roll_fma_chain_reference(x: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version: ``acc = fma_f32(torch.roll(acc, 1, 1), ROLL_C1,
    acc)``, iters times, on (rows, width) x."""
    _check(x, iters)
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, width), got {tuple(x.shape)}")
    acc = x.clone()
    for _ in range(iters):
        acc = fma_f32(torch.roll(acc, 1, 1), ROLL_C1, acc)
    return acc


def _launch(name: str, x: torch.Tensor, *args) -> torch.Tensor:
    """out = dgt_<name>(x, out, *args) on x's device and stream."""
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    from denoise_gan_tpu_torch.ops._build import load_library

    out = torch.empty_like(x)
    with torch.cuda.device(x.device):     # the launch uses the current device
        err = getattr(load_library(), f"dgt_probe_{name}")(
            x.data_ptr(), out.data_ptr(), *args,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"dgt_probe_{name} launch failed: CUDA error {err}")
    return out


def fma_chain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """The FMA chain as one CUDA kernel launch (csrc/probe_fma.cu); same
    contract as :func:`fma_chain_reference`, which runs instead when x lies
    on the CPU.  Any other device launches the kernel or raises: it takes
    contiguous float32 x of any shape."""
    _check(x, iters)
    if x.device.type == "cpu":
        return fma_chain_reference(x, iters)
    require_cuda(x.device)
    out = _launch("fma", x, x.numel(), iters, FMA_C1, FMA_C2)
    launch_counts["fma_chain"] += 1
    return out


def roll_fma_chain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """The roll + FMA chain as one CUDA kernel launch (csrc/probe_fma.cu);
    same contract as :func:`roll_fma_chain_reference`, which runs instead
    when x lies on the CPU.  Any other device launches the kernel or raises:
    it takes contiguous float32 (rows, ROLL_WIDTH) x."""
    _check(x, iters)
    if x.device.type == "cpu":
        return roll_fma_chain_reference(x, iters)
    require_cuda(x.device)
    if x.dim() != 2 or x.shape[1] != ROLL_WIDTH or x.shape[0] >= 2 ** 31:
        raise ValueError(f"the roll kernel takes (rows, {ROLL_WIDTH}), got "
                         f"{tuple(x.shape)}")
    out = _launch("roll_fma", x, x.shape[0], iters, ROLL_C1)
    launch_counts["roll_fma_chain"] += 1
    return out


def seeded_input(device: torch.device, shape=SHAPE) -> torch.Tensor:
    """The JAX probe's x0: standard normal * 1e-3 from
    ``np.random.default_rng(0)``, float32, at SHAPE."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape) * 1e-3
    return torch.from_numpy(x.astype(np.float32)).to(device)


def measure(device: torch.device | str = "cuda") -> list[dict]:
    """The kernels' times on the card, ms per launch over CHAINED chained
    launches and TF/s of the FMA flops (2 per element per iteration, the
    JAX probe's count): each chain at SHAPE with ITERS (ITERS // 2 for the
    roll), the probe's own work, and with LONG_ITERS (// 2), where the
    launch cost no longer counts (``long``); then the roll chain on
    WIDE_ROWS rows, eight warps to a scheduler where SHAPE gives one, to
    tell the shuffle's latency from its throughput."""
    dev = require_cuda(device)
    runs = [(fma_chain, SHAPE, ITERS, False),
            (fma_chain, SHAPE, LONG_ITERS, True),
            (roll_fma_chain, SHAPE, ITERS // 2, False),
            (roll_fma_chain, SHAPE, LONG_ITERS // 2, True),
            (roll_fma_chain, (WIDE_ROWS, SHAPE[1]), LONG_ITERS // 16, True)]
    rows = []
    for fn, shape, iters, long in runs:
        x0 = seeded_input(dev, shape)
        ms = card.time_chained(lambda x, fn=fn, n=iters: fn(x, n), x0,
                               CHAINED)
        flops = 2 * x0.numel() * iters
        rows.append(dict(name=fn.__name__, shape=shape, long=long,
                         iters=iters, ms=ms, flops=flops,
                         tflops=flops / ms / 1e9))
    return rows


def matmul_yardsticks(device: torch.device | str = "cuda") -> list[dict]:
    """tools/exp_vpu_peak.py:82-108 on cuBLAS: for each (M, K, N) of
    MATMUL_SHAPES, CHAINED chained bf16 ``torch.matmul`` steps in form A,
    (M, K) @ (K, N), and form B, (K, N)^T @ (K, M), each feeding
    ``sum(y) * 1e-20`` back into x as the JAX probe does; ms per step and
    TF/s of 2MKN.  torch.matmul returns bf16 where the JAX probe asked
    for f32."""
    dev = require_cuda(device)
    rng = np.random.default_rng(0)

    def bf16(shape):
        a = rng.standard_normal(shape) * 0.01
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)

    rows = []
    for m, k, n in MATMUL_SHAPES:
        b = bf16((k, n))
        for form, x0, prod in (("A", bf16((m, k)), lambda x, b=b: x @ b),
                               ("B", bf16((k, m)), lambda x, b=b: b.t() @ x)):
            def step(x, prod=prod):
                return x + (prod(x).sum() * 1e-20).to(x.dtype)

            ms = card.time_chained(step, x0, CHAINED)
            rows.append(dict(form=form, m=m, k=k, n=n, ms=ms,
                             tflops=2 * m * k * n / ms / 1e9))
    return rows


def main(device: torch.device | str = "cuda") -> None:
    dev = require_cuda(device)
    peak, sms, mhz = card.fp32_peak(dev)
    print(f"{card.smi('name,power.limit', dev.index or 0)}; FP32 peak "
          f"{peak / 1e12:.2f} TF/s = {sms} SMs x {card.FP32_LANES} lanes x 2 "
          f"x {mhz:.0f} MHz (clocks.max.sm)")
    for r in measure(dev):
        print(f"{r['name']} {r['shape']} x {r['iters']} iterations (chained): "
              f"{r['ms']:.4f} ms  {r['tflops']:.2f} TF/s "
              f"({100 * r['tflops'] * 1e12 / peak:.1f}% of the FP32 peak)")
    for r in matmul_yardsticks(dev):
        print(f"torch.matmul form {r['form']} bf16 {r['m']}x{r['k']}x{r['n']} "
              f"(chained): {r['ms']:.4f} ms  {r['tflops']:.1f} TF/s")


if __name__ == "__main__":
    main()
