"""Relayout probe (K8): the tensor cores' rate by operand layout, and the
cost of in-kernel transposes.

Counterpart of tools/exp_relayout.py's in-kernel sections D (``mm_kernel``)
and E (``tk``), which measured the TPU matrix unit by dot_general form and
a (1536, 128) f32 transpose inside a kernel, for the fused tail's layout
choices.

* ``matmul_form(x, w, form, reps)``: the bf16 product in f32, ``reps``
  times; returns ``(acc, y)``, acc the serial f32 sum of y[0, 0] over the
  reps (the JAX probe's output) and y the last rep's product.
  ``canonical``: y = x (M, K) @ w (K, N), (M, N).  ``sublane``: y = w^T . x
  with x (K, M) and w (K, N), (N, M), both operands contracted on their
  leading axis.  In mma.sync terms the canonical A operand is K-major
  (``ldmatrix``) and the sublane one MN-major (``ldmatrix.trans``); B is
  MN-major in both (csrc/probe_relayout.cu).
* ``transpose_chain(x, iters)``: ``iters`` times ``t = acc^T * 1.000001;
  acc = t^T`` on f32 x, two transposes an iteration.

The wrappers launch the CUDA kernels of csrc/probe_relayout.cu; on tensors
that lie on the CPU they run the plain versions.
``matmul_form_reference`` sums the product in float64 and rounds it to
f32, an ideal f32 accumulator (every rep's product is the same, so it is
taken once), and adds y[0, 0] ``reps`` times in f32; the kernel's f32 sums
run in another order (``product_bound``).  ``transpose_chain_reference``
makes the same transposes and f32 multiplies, so kernel and plain version
agree bit for bit.

    python -m denoise_gan_tpu_torch.probes.relayout     # on a CUDA GPU

times both forms at the JAX probe's three shapes with its 64 reps (a few
microseconds of work, where launch cost counts) and with LONG_REPS, the
transpose chain with 8 and LONG_ITERS iterations, and beside them the same
work through PyTorch calls (``torch.matmul``; ``.t().contiguous()`` and
``mul``), and prints the kernel's LDSM and HMMA counts by cuobjdump.
"""

from __future__ import annotations

import numpy as np
import torch

from denoise_gan_tpu_torch.utils import card
from denoise_gan_tpu_torch.utils.device import require_cuda

REPS = 64                                         # tools/exp_relayout.py:38
SHAPES = ((2048, 384, 128), (2048, 1152, 128), (1024, 1152, 48))  # :112
FORMS = ("canonical", "sublane")                  # :113
TK_SHAPE = (1536, 128)                            # :117
TK_ITERS = 8                                      # :124, 16 transposes
TK_C = float(np.float32(1.000001))                # :121
LONG_REPS = 4096          # one launch >= 1 ms at every shape
LONG_ITERS = 8192         # one transpose-chain launch >= 1 ms
TIMED = 20                # timed launches after a warm-up (LONG: 3)

# Plain integers: the kernels' launches, the product's by form.
launch_counts = {"matmul_form:canonical": 0, "matmul_form:sublane": 0,
                 "transpose_chain": 0}


def _check_mm(x: torch.Tensor, w: torch.Tensor, form: str,
              reps: int) -> tuple[int, int, int]:
    """(M, K, N) of a valid matmul_form call; raises ValueError."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"x and w must be bf16, got {x.dtype} and "
                         f"{w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or min(*x.shape, *w.shape) < 1:
        raise ValueError(f"x and w must be non-empty 2-D, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    k, n = w.shape
    m = x.shape[0] if form == "canonical" else x.shape[1]
    want = (m, k) if form == "canonical" else (k, m)
    if tuple(x.shape) != want:
        raise ValueError(f"{form}: x must be {want} for w (K, N) = "
                         f"{(k, n)}, got {tuple(x.shape)}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    return m, k, n


@torch.no_grad()
def matmul_form_reference(x: torch.Tensor, w: torch.Tensor, form: str,
                          reps: int = REPS
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`matmul_form`: the product summed in float64
    and rounded to f32, and y[0, 0] added ``reps`` times in f32."""
    _check_mm(x, w, form, reps)
    y = x.double() @ w.double() if form == "canonical" \
        else w.double().t() @ x.double()
    y = y.float()
    v, acc = np.float32(y[0, 0].item()), np.float32(0)
    for _ in range(reps):
        acc = np.float32(acc + v)
    return torch.tensor(float(acc), dtype=torch.float32, device=y.device), y


def matmul_form(x: torch.Tensor, w: torch.Tensor, form: str,
                reps: int = REPS) -> tuple[torch.Tensor, torch.Tensor]:
    """The product ``reps`` times as one CUDA kernel launch
    (csrc/probe_relayout.cu); same contract as
    :func:`matmul_form_reference`, which runs instead when the tensors lie
    on the CPU.  Any other device launches the kernel or raises: it takes
    contiguous bf16 x and w, and its launch fails (RuntimeError) unless
    K % 64 == 0 and K <= 1152."""
    m, k, n = _check_mm(x, w, form, reps)
    if x.device.type == "cpu":
        return matmul_form_reference(x, w, form, reps)
    require_cuda(x.device)
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("x and w must be contiguous")
    from denoise_gan_tpu_torch.ops._build import load_library

    p, q = (m, n) if form == "canonical" else (n, m)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    y = torch.empty((p, q), dtype=torch.float32, device=x.device)
    acc = torch.empty((), dtype=torch.float32, device=x.device)
    # the kernel's scratch: its split CTAs' arrival count and partial sums
    parts = torch.empty(sms + 1, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):     # the launch uses the current device
        err = load_library().dgt_probe_matmul_form(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), parts.data_ptr(),
            acc.data_ptr(), m, k, n, int(form == "sublane"), reps, sms,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"dgt_probe_matmul_form launch failed: CUDA error "
                           f"{err}")
    launch_counts[f"matmul_form:{form}"] += 1
    return acc, y


def product_bound(x: torch.Tensor, w: torch.Tensor, form: str
                  ) -> torch.Tensor:
    """Per-element bound on |y - the plain version's y|: K * 2**-24 *
    sum_k |x_k w_k|, f32 sums in any order against an ideal accumulator
    (float64, the shape of y)."""
    k = w.shape[0]
    ax, aw = x.double().abs(), w.double().abs()
    s = ax @ aw if form == "canonical" else aw.t() @ ax
    return k * 2.0 ** -24 * s


def acc_bound(y_bound: torch.Tensor, acc: torch.Tensor, reps: int) -> float:
    """Bound on |acc - the plain version's acc|: reps times y[0, 0]'s bound
    plus reps f32 ulps (2**-23) of |acc|: the reps' sums may be added in
    another order."""
    return reps * float(y_bound[0, 0]) + reps * 2.0 ** -23 * abs(float(acc))


def seeded_operands(m: int, k: int, n: int, form: str,
                    device: torch.device | str = "cuda",
                    rng: np.random.Generator | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x, w) by the JAX probe's recipe (:57-62): standard normal * 0.01 in
    bf16, x (M, K) canonical or (K, M) sublane, w (K, N), from
    ``np.random.default_rng(0)`` unless `rng` is given (rounded through
    f32 here, directly from float64 by jnp)."""
    rng = np.random.default_rng(0) if rng is None else rng
    xs = (m, k) if form == "canonical" else (k, m)
    x, w = (torch.from_numpy((rng.standard_normal(s) * .01).astype(
        np.float32)).to(device, torch.bfloat16) for s in (xs, (k, n)))
    return x, w


@torch.no_grad()
def transpose_chain_reference(x: torch.Tensor,
                              iters: int = TK_ITERS) -> torch.Tensor:
    """Plain version: ``iters`` times ``acc = (acc^T * TK_C)^T`` in f32 on
    (rows, cols) x."""
    _check_tk(x, iters)
    acc = x.clone()
    for _ in range(iters):
        acc = (acc.t() * TK_C).t()
    return acc.contiguous()


def _check_tk(x: torch.Tensor, iters: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty 2-D float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


def transpose_chain(x: torch.Tensor, iters: int = TK_ITERS) -> torch.Tensor:
    """The transpose chain as one CUDA kernel launch
    (csrc/probe_relayout.cu); same contract as
    :func:`transpose_chain_reference`, which runs instead when x lies on
    the CPU.  Any other device launches the kernel or raises: it takes
    contiguous (rows, cols) float32 x."""
    _check_tk(x, iters)
    if x.device.type == "cpu":
        return transpose_chain_reference(x, iters)
    require_cuda(x.device)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    from denoise_gan_tpu_torch.ops._build import load_library

    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = load_library().dgt_probe_transpose_chain(
            x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], iters,
            TK_C, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"dgt_probe_transpose_chain launch failed: CUDA "
                           f"error {err}")
    launch_counts["transpose_chain"] += 1
    return out


def seeded_block(device: torch.device | str = "cuda",
                 shape: tuple[int, int] = TK_SHAPE) -> torch.Tensor:
    """The JAX probe's transpose input (:117): standard normal f32 from
    ``np.random.default_rng(0)``."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device)


def library_products(x: torch.Tensor, w: torch.Tensor, form: str,
                     reps: int) -> torch.Tensor:
    """The kernel's yardstick: ``reps`` products by one ``torch.matmul``
    call each (cuBLAS, f32 sums, bf16 out); the last."""
    for _ in range(reps):
        y = torch.matmul(x, w) if form == "canonical" \
            else torch.matmul(w.t(), x)
    return y


@torch.no_grad()
def library_transpose_chain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """The transpose chain through PyTorch calls, the kernel's yardstick:
    each transpose a ``.t().contiguous()`` copy, the multiply a ``mul``."""
    acc = x
    for _ in range(iters):
        acc = (acc.t().contiguous() * TK_C).t().contiguous()
    return acc


def sass_counts() -> dict[str, dict[str, int]]:
    """Per form, the product kernel's LDSM instructions (all, and the
    transposed LDSM.16.MT88) and HMMA instructions in the built library's
    SASS (``_build.sass_functions``); {} where the toolkit has no
    cuobjdump."""
    from denoise_gan_tpu_torch.ops import _build

    counts = {}
    for name, block in _build.sass_functions().items():
        if "matmul_form_kernel" not in name:
            continue
        lines = block.splitlines()
        counts["sublane" if "ILb1E" in name else "canonical"] = {
            op: sum(op in line for line in lines)
            for op in ("LDSM", "LDSM.16.MT88", "HMMA")}
    return counts


def ops(m: int, k: int, n: int, reps: int) -> int:
    """Multiply-adds x 2 of ``reps`` products."""
    return 2 * m * k * n * reps


def measure(device: torch.device | str = "cuda") -> list[dict]:
    """The kernels' times on the card, ms per launch by CUDA events after
    a warm-up, queued behind a device sleep (``card.queued_ms``: the
    wrapper's host time is not counted; TIMED launches, 3 at the long
    counts): each form at each of
    SHAPES with REPS and LONG_REPS reps (``long``), with T/s; the transpose
    chain on TK_SHAPE with TK_ITERS and LONG_ITERS iterations."""
    dev = require_cuda(device)
    rows = []
    for m, k, n in SHAPES:
        for form in FORMS:
            x, w = seeded_operands(m, k, n, form, dev)
            for reps, long in ((REPS, False), (LONG_REPS, True)):
                ms = card.queued_ms(lambda: matmul_form(x, w, form, reps),
                                    3 if long else TIMED)
                rows.append(dict(name=f"matmul_form:{form}", shape=(m, k, n),
                                 reps=reps, long=long, ms=ms,
                                 tops=ops(m, k, n, reps) / ms / 1e9))
    x = seeded_block(dev)
    for iters, long in ((TK_ITERS, False), (LONG_ITERS, True)):
        ms = card.queued_ms(lambda: transpose_chain(x, iters),
                            3 if long else TIMED)
        rows.append(dict(name="transpose_chain", shape=TK_SHAPE, reps=iters,
                         long=long, ms=ms, tops=None))
    return rows


def main(device: torch.device | str = "cuda") -> None:
    dev = require_cuda(device)
    print(card.smi("name,power.limit", dev.index or 0))
    for form, c in sass_counts().items():
        print(f"matmul_form_kernel<{form}> SASS: {c}")
    for r in measure(dev):
        if r["name"] == "transpose_chain":
            x = seeded_block(dev)
            lib = card.cuda_ms(
                lambda: library_transpose_chain(x, r["reps"]), 3)
            print(f"transpose_chain {r['shape']} x {r['reps']} iterations: "
                  f"{r['ms']:.4f} ms; by .t().contiguous() and mul "
                  f"{lib:.4f} ms")
            continue
        m, k, n = r["shape"]
        x, w = seeded_operands(m, k, n, r["name"].split(":")[1], dev)
        lib = card.cuda_ms(lambda: library_products(
            x, w, r["name"].split(":")[1], r["reps"]), 3)
        print(f"{r['name']} {m}x{k}x{n} x {r['reps']} reps: {r['ms']:.4f} ms "
              f"({r['tops']:.1f} T/s); by torch.matmul {lib:.4f} ms")


if __name__ == "__main__":
    main()
