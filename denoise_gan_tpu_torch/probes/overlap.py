"""Overlap probe (K7): a tensor-core product chain beside a roll + FMA chain,
alone and interleaved in one loop body.

Counterpart of tools/exp_overlap_probe.py, which asked whether one TPU
core's matrix unit and vector unit overlap when one kernel's loop holds
both chains.  Its state (``initial_state``) is y (128, M) bf16, z (8, M)
f32 and w (128, 128) bf16, M = 15360; ``overlap_chain(y, z, w, mxu_iters,
vpu_iters)`` runs n = max(mxu_iters, vpu_iters) iterations of

* when mxu_iters is not 0: s = w . y over all M columns (f32 sums),
  y[:, 0:128] = bf16(s[:, 0:128]);
* when vpu_iters is not 0: z = z * 0.999 + roll(z, 1, axis 1) * 0.001,
  roll(a, 1)[:, j] = a[:, j - 1], wrapping;

and returns the new y and z and the probe's output o = f32(y[0:8, 0:128]) +
z[:, 0:128].  Both tests are the JAX probe's truthiness tests, kept as they
are: in mode c, (mxu_iters, vpu_iters) both non-zero, each chain runs
max(mxu_iters, vpu_iters) iterations, so at the JAX counts (4000, 3000) the
probe's own "sum" t(a) + t(b) adds 3000 roll steps where t(c) holds 4000.
``compare`` also gives the comparison at equal counts and the overlap
share.

The chains, as the kernel of csrc/probe_overlap.cu computes them and the
plain version ``overlap_chain_reference`` repeats them:

* y: the kernel sums each product in f32 (mma.sync) and rounds to bf16;
  the plain version sums in float64 and rounds to f32, an ideal f32
  accumulator, then to bf16, so a step's two results may be one bf16
  rounding apart (``step_bound``).  w is skew-symmetric with spectral norm
  4.73, so y's changing columns grow ~4.7x a step, leave bf16's finite
  range near step 55 and are NaN by step 60: at the JAX counts the product
  chain works on non-finite data, on the TPU as here.  Columns 128.. never
  change, but every iteration computes their product: it is the probe's
  work.
* z: fmaf(z, 0.999, roll(z) * 0.001), the product rounded once and then a
  fused multiply-add (the order XLA's CPU backend contracts the JAX
  expression to); the plain version rounds the same way
  (``fma_peak.fma_f32``), so z is bit-identical.

The wrapper launches the kernel for tensors on a CUDA device, where it
takes only the JAX shape, and raises otherwise; on tensors that lie on the
CPU it runs the plain version.  Launch counts are keyed by mode: ``mxu``
(a), ``vpu`` (b), ``both`` (c).

    python -m denoise_gan_tpu_torch.probes.overlap      # on a CUDA GPU

prints the kernel's SASS counts inside its loops (cuobjdump), times the
three modes at the JAX counts and at equal counts EQUAL_ITERS, with the
overlap share, then the share over SWEEP equal counts.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from denoise_gan_tpu_torch.probes import int8_chain
from denoise_gan_tpu_torch.probes.fma_peak import fma_f32
from denoise_gan_tpu_torch.utils import card
from denoise_gan_tpu_torch.utils.device import require_cuda, resolve_device

M = 15360                   # tools/exp_overlap_probe.py:30
ROWS = 128                  # rows of y and w
ZROWS = 8                   # rows of z
MXU_ITERS, VPU_ITERS = 4000, 3000          # :87-88
C1 = float(np.float32(0.999))              # :54
C2 = float(np.float32(0.001))
# the equal count n of t(a) at (n, 0), t(b) at (0, n) and t(c) at (n, n),
# fixed by main's SWEEP on an NVIDIA H100 80GB HBM3 at 700 W: t(a) / t(b)
# is 2.97-3.13 at every n (both are linear in n), so no n makes them
# equal; at 4000 the smaller is 1.49 ms and the share is within 0.05 of
# 8000's and 16000's
EQUAL_ITERS = 4000
SWEEP = (1000, 2000, 4000, 8000, 16000)    # main's equal counts
TIMED = 5                   # timed launches after a warm-up
MODES = {(True, False): "mxu", (False, True): "vpu", (True, True): "both"}

# Plain integers: the kernel's launches, by mode.
launch_counts = {f"overlap_chain:{m}": 0 for m in MODES.values()}


def mode(mxu_iters: int, vpu_iters: int) -> str | None:
    """The mode of a call, ``mxu``, ``vpu`` or ``both``; None for (0, 0)."""
    return MODES.get((bool(mxu_iters), bool(vpu_iters)))


def initial_state(device: torch.device | str = "cuda"
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, z, w) of the JAX probe (:35-40): y[r, c] = bf16(f32(c) *
    f32(1e-4)), z[r, c] = f32(c) * f32(1e-4), w[r, c] = bf16(f32(r - c) *
    f32(1e-3))."""
    dev = resolve_device(device)
    cols = np.arange(M, dtype=np.float32) * np.float32(1e-4)
    r = np.arange(ROWS)
    w = (r[:, None] - r[None, :]).astype(np.float32) * np.float32(1e-3)
    y = torch.from_numpy(np.broadcast_to(cols, (ROWS, M)).copy())
    z = torch.from_numpy(np.broadcast_to(cols, (ZROWS, M)).copy())
    return (y.to(dev, torch.bfloat16), z.to(dev),
            torch.from_numpy(w).to(dev, torch.bfloat16))


def _check(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
           mxu_iters: int, vpu_iters: int) -> None:
    if y.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or \
            z.dtype != torch.float32:
        raise ValueError(f"y and w must be bf16 and z float32, got "
                         f"{y.dtype}, {w.dtype} and {z.dtype}")
    if y.dim() != 2 or y.shape[0] != ROWS or y.shape[1] < ROWS or \
            tuple(z.shape) != (ZROWS, y.shape[1]) or \
            tuple(w.shape) != (ROWS, ROWS):
        raise ValueError(f"y must be ({ROWS}, m >= {ROWS}), z ({ZROWS}, m) "
                         f"and w ({ROWS}, {ROWS}), got {tuple(y.shape)}, "
                         f"{tuple(z.shape)} and {tuple(w.shape)}")
    if not y.device == z.device == w.device:
        raise ValueError(f"y on {y.device}, z on {z.device}, w on "
                         f"{w.device}")
    if mxu_iters < 0 or vpu_iters < 0:
        raise ValueError(f"iteration counts must be >= 0, got "
                         f"({mxu_iters}, {vpu_iters})")


def output(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The probe's output o = f32(y[0:8, 0:128]) + z[:, 0:128] (:58)."""
    return y[:ZROWS, :ROWS].float() + z[:, :ROWS]


@torch.no_grad()
def overlap_chain_reference(y: torch.Tensor, z: torch.Tensor,
                            w: torch.Tensor, mxu_iters: int, vpu_iters: int
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of :func:`overlap_chain` (module docstring): the
    product of the 128 columns that change, summed in float64, rounded to
    f32 and then bf16; z by ``fma_f32``."""
    _check(y, z, w, mxu_iters, vpu_iters)
    y, z = y.clone(), z.clone()
    wd = w.double()
    for _ in range(max(mxu_iters, vpu_iters)):
        if mxu_iters:
            y[:, :ROWS] = (wd @ y[:, :ROWS].double()).float().bfloat16()
        if vpu_iters:
            z = fma_f32(z, C1, torch.roll(z, 1, 1) * C2)
    return y, z, output(y, z)


def overlap_chain(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  mxu_iters: int, vpu_iters: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The probe's chains as one CUDA kernel launch (csrc/probe_overlap.cu)
    from the state (y, z, w): (y, z, o) after max(mxu_iters, vpu_iters)
    iterations (module docstring); y and z are new tensors.  Same contract
    as :func:`overlap_chain_reference`, which runs instead when the tensors
    lie on the CPU.  Any other device launches the kernel or raises: it
    takes contiguous y (128, 15360), z (8, 15360) and w (128, 128).  At
    (0, 0) nothing runs and no kernel is launched."""
    _check(y, z, w, mxu_iters, vpu_iters)
    if y.device.type == "cpu":
        return overlap_chain_reference(y, z, w, mxu_iters, vpu_iters)
    require_cuda(y.device)
    if y.shape[1] != M:
        raise ValueError(f"the kernel takes m = {M} columns, got "
                         f"{y.shape[1]}")
    if not (y.is_contiguous() and z.is_contiguous() and w.is_contiguous()):
        raise ValueError("y, z and w must be contiguous")
    y, z = y.clone(), z.clone()
    m = mode(mxu_iters, vpu_iters)
    if m is None:
        return y, z, output(y, z)
    from denoise_gan_tpu_torch.ops._build import load_library

    with torch.cuda.device(y.device):     # the launch uses the current device
        err = load_library().dgt_probe_overlap(
            w.data_ptr(), y.data_ptr(), z.data_ptr(),
            max(mxu_iters, vpu_iters), int(bool(mxu_iters)),
            int(bool(vpu_iters)), C1, C2,
            torch.cuda.current_stream(y.device).cuda_stream)
    if err:
        raise RuntimeError(f"dgt_probe_overlap launch failed: CUDA error "
                           f"{err}")
    launch_counts[f"overlap_chain:{m}"] += 1
    return y, z, output(y, z)


def step_bound(y: torch.Tensor, w: torch.Tensor,
               want: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |kernel - plain version| for y's changing
    columns 0..127 after one product step from y, where want is the plain
    version's new y: ``int8_chain.bf16_step_bound`` of the product w . y
    (one bf16 rounding apart after f32 sums in different orders).  float64,
    (128, 128)."""
    return int8_chain.bf16_step_bound(y[:, :ROWS], w.t(), want[:, :ROWS])


def ops(mxu_iters: int, vpu_iters: int) -> tuple[int, int]:
    """(tensor-core flops, CUDA-core flops) of a call: 2 * 128 * 128 * M
    an iteration of the product, 3 * 8 * M of the roll + FMA (a multiply
    and a multiply-add), over max(mxu_iters, vpu_iters) iterations."""
    n = max(mxu_iters, vpu_iters)
    return (2 * ROWS * ROWS * M * n if mxu_iters else 0,
            3 * ZROWS * M * n if vpu_iters else 0)


def n_bytes() -> int:
    """Bytes a call must move: y and z read and written once, w read once,
    o written once."""
    return 2 * (ROWS * M * 2 + ZROWS * M * 4) + ROWS * ROWS * 2 \
        + ZROWS * ROWS * 4


@torch.no_grad()
def library_chain(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  mxu_iters: int, vpu_iters: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chains through PyTorch's library calls, the kernel's yardstick:
    each iteration ``torch.matmul(w, y)`` (cuBLAS, f32 sums, bf16 out; the
    whole product) with columns 0..127 written back, and ``torch.roll`` +
    ``mul`` + ``mul`` + ``add`` on z (each rounded)."""
    _check(y, z, w, mxu_iters, vpu_iters)
    y = y.clone()
    for _ in range(max(mxu_iters, vpu_iters)):
        if mxu_iters:
            y[:, :ROWS] = torch.matmul(w, y)[:, :ROWS]
        if vpu_iters:
            z = z * C1 + torch.roll(z, 1, 1) * C2
    return y, z


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRA = re.compile(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")
SASS_OPS = ("HMMA", "LDSM", "SHFL", "FFMA", "FMUL", "BAR")


def loop_counts(sass: str) -> list[dict[str, int]]:
    """For each loop of one function's SASS (a branch back to an earlier
    instruction, by label or by address), the count of each of SASS_OPS
    between its target and the branch, and the loop's instruction count
    (``insns``)."""
    insns, labels = [], {}
    pending = []
    for line in sass.splitlines():
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            insns.append((addr, m.group(2).strip()))
    loops = []
    for addr, text in insns:
        b = _BRA.search(text)
        if not b:
            continue
        target = labels.get(b.group(1)) if b.group(1) else int(b.group(2), 16)
        if target is None or target > addr:
            continue
        body = [t for a, t in insns if target <= a <= addr]
        opcodes = [t.split()[1] if t.startswith("@") else t.split()[0]
                   for t in body]
        loops.append({"insns": len(body), **{
            op: sum(o.split(".")[0] == op for o in opcodes)
            for op in SASS_OPS}})
    return loops


def sass_loop_counts() -> dict[str, list[dict[str, int]]]:
    """Per mode, the loops of the kernel's SASS in the built library
    (``_build.sass_functions``) that hold an HMMA or a SHFL
    (``loop_counts``); {} where the toolkit has no cuobjdump."""
    from denoise_gan_tpu_torch.ops import _build

    counts = {}
    for name, block in _build.sass_functions().items():
        flags = re.search(r"overlap_kernelILb([01])ELb([01])E", name)
        if flags:
            key = MODES[bool(int(flags.group(1))), bool(int(flags.group(2)))]
            counts[key] = [c for c in loop_counts(block)
                           if c["HMMA"] or c["SHFL"]]
    return counts


def compare(ms: dict[tuple[int, int], float], n: int = EQUAL_ITERS
            ) -> dict[str, float]:
    """From ms by (mxu_iters, vpu_iters): the JAX probe's comparison at its
    counts (``jax_sum`` = t(a) + t(b), ``jax_max``, ``jax_c``; its t(c)
    runs both chains max(4000, 3000) times), and at equal counts n
    (``sum``, ``max``, ``c``) with the overlap share (t(a) + t(b) - t(c)) /
    min(t(a), t(b)): 1 where the units overlap fully, 0 where they
    serialise."""
    ta, tb, tc = ms[n, 0], ms[0, n], ms[n, n]
    ja, jb = ms[MXU_ITERS, 0], ms[0, VPU_ITERS]
    return {"jax_sum": ja + jb, "jax_max": max(ja, jb),
            "jax_c": ms[MXU_ITERS, VPU_ITERS], "sum": ta + tb,
            "max": max(ta, tb), "c": tc,
            "share": (ta + tb - tc) / min(ta, tb)}


def measure(device: torch.device | str = "cuda", n: int = EQUAL_ITERS
            ) -> dict[tuple[int, int], float]:
    """The kernel's ms per call from the initial state, by CUDA events
    after a warm-up (the mean of TIMED calls, the wrapper's copies of y and
    z included), for each (mxu_iters, vpu_iters) that ``compare(ms, n)``
    reads, each once."""
    dev = require_cuda(device)
    y, z, w = initial_state(dev)
    counts = dict.fromkeys([(MXU_ITERS, 0), (0, VPU_ITERS),
                            (MXU_ITERS, VPU_ITERS), (n, 0), (0, n), (n, n)])
    return {(mi, vi): card.cuda_ms(
        lambda mi=mi, vi=vi: overlap_chain(y, z, w, mi, vi), TIMED)
        for mi, vi in counts}


def main(device: torch.device | str = "cuda") -> None:
    dev = require_cuda(device)
    print(card.smi("name,power.limit", dev.index or 0))
    for key, loops in sass_loop_counts().items():
        print(f"overlap_kernel<{key}> SASS loops: {loops}")
    for n in SWEEP:
        ms = measure(dev, n)
        c = compare(ms, n)
        print(f"n={n}: t(a) {ms[n, 0]:.3f} ms, t(b) {ms[0, n]:.3f}, t(c) "
              f"{c['c']:.3f}; sum {c['sum']:.3f}, max {c['max']:.3f}, "
              f"overlap share {c['share']:.3f}, t(a)/t(b) "
              f"{ms[n, 0] / ms[0, n]:.2f}")
        if n == EQUAL_ITERS:
            print(f"JAX counts ({MXU_ITERS}, {VPU_ITERS}): t(a) "
                  f"{ms[MXU_ITERS, 0]:.3f}, t(b) {ms[0, VPU_ITERS]:.3f}, "
                  f"t(c) {c['jax_c']:.3f}; the probe's sum "
                  f"{c['jax_sum']:.3f} and max {c['jax_max']:.3f} (its t(c) "
                  f"runs both chains {MXU_ITERS} times)")


if __name__ == "__main__":
    main()
