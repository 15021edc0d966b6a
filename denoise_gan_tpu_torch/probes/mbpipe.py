"""Inverted-residual band-pipeline probe (K5): one band step of the FSRGAN
body's inverted residual, expand and project on tensor cores and the 3x3
depthwise on CUDA cores, one chain of steps against two independent chains.

Counterpart of tools/exp_mbpipe.py, which asked whether a TPU core
overlaps chain A's matrix-unit dots with chain B's vector-unit depthwise.
A band is r (32, 2176) bf16: 17 rows of 128 pixels flattened, 32 channels.
The state (``initial_state``, the JAX kernel's :42-48) is the two chains'
bands r1[k, j] = bf16(j * 1e-5) and r2[k, j] = bf16(j * 1e-5 + 0.5), the
weights we[k, c] = bf16(k * 1e-3 - c * 1e-3) (32, 192) and wp = we^T (192,
32) bf16, and wdw[t, c] = c * 1e-4 (9, 192) f32.  One step on a band r
(block_step, :50-73):

* E = relu(we^T r + 0.01), (192, 2176) f32, bf16 x bf16 products summed
  in f32 (``expand_reference``);
* D = relu(acc + 0.01), (192, 1920) f32, acc the 9 taps wdw[3 dr + dc] *
  src_dc[:, 128 dr : 128 dr + 1920] from 0 in the order dr, then src =
  (roll(E, 1), E, roll(E, -1)) on the flat axis (a row's edge taps read
  the neighbouring row; the band's ends wrap), each tap one multiply-add
  rounded once (``fma_f32``, the kernel's fmaf) (``depthwise_reference``);
* p = wp^T D, (32, 1920) f32, bf16 x f32 (``project_reference``);
* r[:, 128:2048] = bf16(f32(r[:, 128:2048]) + p * 1e-3), the product and
  the sum each rounded to f32 (``update_reference``; XLA's CPU backend
  gives the same bf16 fused or not).

``mbpipe_chain(state, reps, chains)`` runs `reps` steps of chain 1 (r1)
and, with chains = 2, of chain 2 (r2) too, and returns (r1, r2, e, d, p):
the new bands and E, D and p of each chain's last step, stacked over the
chains (e (chains, 192, 2176)).  r1 and r2 may carry a leading band axis
(bands, 32, 2176): each band is its own chain (the outputs then lead with
it too).  The kernel (csrc/probe_mbpipe.cu) sums E and p on tensor cores
(p from D split exactly into three bf16 pieces); the plain version
``mbpipe_chain_reference`` sums them in float64 and rounds to f32, an
ideal f32 accumulator, so the two are apart within ``expand_bound`` and
``project_bound``; given the same E, D is bit-identical, and given the
same p, the new r.

The JAX probe's output o = r1[0:8, 0:128] + r2[0:8, 0:128] reads columns
that no step writes, and chain 2 is a fixed point (p * 1e-3 is below half
a bf16 ulp at 0.5): the checks compare the whole buffers.

The wrapper launches the kernel for tensors on a CUDA device (one CTA a
band) and raises otherwise; on tensors that lie on the CPU it runs the
plain version.

    python -m denoise_gan_tpu_torch.probes.mbpipe      # on a CUDA GPU

runs every mode (MODES: one chain; two chains with their own barriers,
and with one barrier, their phases aligned or offset) on one band per SM
for REPS steps, in order and in reverse order, and prints us per band
step over the card, the SM clock, power and temperature while it runs,
the TPU geometry's frame (FRAME_STEPS band steps), the bound (the
CUDA-core operations at the FP32 peak, which exceed the tensor-core flops
at the bf16 peak), at LINE_REPS steps the plain version and the same
steps through ``torch.matmul``, ``torch.roll`` and elementwise ops
(``library_chain``), and two ratios: the gain t1/t2, which mixes overlap
of the tensor and CUDA cores with ordinary latency hiding between the
chains' warps, and aligned/offset, where both pay the same barrier waits
and only what runs beside what differs.
"""

from __future__ import annotations

import numpy as np
import torch

from denoise_gan_tpu_torch.probes.fma_peak import fma_f32
from denoise_gan_tpu_torch.utils import card
from denoise_gan_tpu_torch.utils.device import require_cuda, resolve_device

NR = 32                     # channels of a band (K of the expand)
NE = 192                    # expanded channels
CHUNK = 128                 # a band row
MB = 17 * CHUNK             # tools/exp_mbpipe.py:30
MP = 15 * CHUNK             # :31
REPS = 1500                 # :111
FRAME_STEPS = 7119          # the TPU geometry's band steps a frame (:113)
BIAS = float(np.float32(0.01))   # :58, :67
CU = float(np.float32(1e-3))     # :73
CHAINS = (1, 2)
# how two chains' warps meet at the barriers between phases
# (csrc/probe_mbpipe.cu): each its own, or one barrier with the chains'
# phases aligned, or offset by one interval (a tensor-core phase of one
# chain beside the depthwise of the other)
SYNCS = ("own", "aligned", "offset")
MODES = ((1, "own"), (2, "own"), (2, "aligned"), (2, "offset"))
LINE_REPS = 32              # steps of the plain and library yardsticks
TIMED = 3                   # timed launches after a warm-up
CLOCK_QUERY = "clocks.sm,power.draw,temperature.gpu"   # read while timing


def mode_key(chains: int, sync: str = "own") -> str:
    """A mode's launch-count key: ``mbpipe_chain:<chains>[:<sync>]``."""
    return f"mbpipe_chain:{chains}" + ("" if sync == "own" else f":{sync}")


# Plain integers: the kernel's launches, by mode.
launch_counts = {mode_key(c, s): 0 for c, s in MODES}

State = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]


def initial_state(device: torch.device | str = "cuda") -> State:
    """(r1, r2, we, wp, wdw) of the JAX probe (:42-48), each operation
    rounded to f32 as it reads, then to bf16 (the JAX kernel's values)."""
    dev = resolve_device(device)
    f = np.float32
    j = np.arange(MB, dtype=f) * f(1e-5)
    r1 = np.broadcast_to(j, (NR, MB))
    r2 = np.broadcast_to(j + f(0.5), (NR, MB))
    k = np.arange(NR, dtype=f)[:, None] * f(1e-3)
    c = np.arange(NE, dtype=f)[None, :] * f(1e-3)
    we = k - c
    wdw = np.broadcast_to(np.arange(NE, dtype=f) * f(1e-4), (9, NE))

    def bf(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            dev, torch.bfloat16)

    return (bf(r1), bf(r2), bf(we), bf(we.T),
            torch.from_numpy(np.ascontiguousarray(wdw)).to(dev))


def seeded_state(seed: int, bands: int | None = None,
                 device: torch.device | str = "cuda") -> State:
    """A random state from numpy's generator: r1, r2 ~ N(0, 0.5) (bands,
    32, 2176) (or (32, 2176) for bands None), we, wp ~ N(0, 0.2) in bf16,
    wdw ~ N(0, 0.2) f32.  p * 1e-3 then moves a share of both chains' r
    by a bf16 step, and relu zeroes a share of E and D."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    lead = () if bands is None else (bands,)

    def draw(shape, std, dtype=torch.bfloat16):
        a = (rng.standard_normal(shape) * std).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)

    return (draw(lead + (NR, MB), 0.5), draw(lead + (NR, MB), 0.5),
            draw((NR, NE), 0.2), draw((NE, NR), 0.2),
            draw((9, NE), 0.2, torch.float32))


def band_state(state: State, bands: int) -> State:
    """The state with r1 and r2 repeated over a leading band axis."""
    r1, r2, *w = state
    return (r1.expand(bands, NR, MB).contiguous(),
            r2.expand(bands, NR, MB).contiguous(), *w)


def _validate(state: State, reps: int, chains: int, sync: str = "own"
           ) -> None:
    if len(state) != 5:
        raise ValueError("state is (r1, r2, we, wp, wdw)")
    r1, r2, we, wp, wdw = state
    if (chains, sync) not in MODES:
        raise ValueError(f"(chains, sync) must be one of {MODES}, got "
                         f"{(chains, sync)}")
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    if not (r1.dtype == r2.dtype == we.dtype == wp.dtype == torch.bfloat16
            and wdw.dtype == torch.float32):
        raise ValueError(f"r1, r2, we, wp must be bf16 and wdw float32, got "
                         f"{[t.dtype for t in state]}")
    if r1.dim() not in (2, 3) or tuple(r1.shape[-2:]) != (NR, MB) or \
            r2.shape != r1.shape or tuple(we.shape) != (NR, NE) or \
            tuple(wp.shape) != (NE, NR) or tuple(wdw.shape) != (9, NE):
        raise ValueError(
            f"r1 and r2 must be ([bands,] {NR}, {MB}), we ({NR}, {NE}), wp "
            f"({NE}, {NR}), wdw (9, {NE}); got "
            f"{[tuple(t.shape) for t in state]}")
    if len({t.device for t in state}) != 1:
        raise ValueError(f"tensors on {[str(t.device) for t in state]}")


def expand_reference(r: torch.Tensor, we: torch.Tensor) -> torch.Tensor:
    """E = relu(we^T r + 0.01) (..., 192, 2176) f32: the sum in float64,
    rounded to f32 (an ideal f32 accumulator), then the f32 add."""
    s = (we.double().t() @ r.double()).float()
    return torch.clamp_min(s + BIAS, 0.0)


def depthwise_reference(e: torch.Tensor, wdw: torch.Tensor) -> torch.Tensor:
    """D = relu(acc + 0.01) (..., 192, 1920) from E: acc the nine taps from
    0 in the JAX order (module docstring), each by ``fma_f32``."""
    srcs = (torch.roll(e, 1, -1), e, torch.roll(e, -1, -1))
    w = wdw[:, :, None]
    acc = torch.zeros(e.shape[:-1] + (MP,), dtype=torch.float32,
                      device=e.device)
    for dr in range(3):
        for dc, src in enumerate(srcs):
            acc = fma_f32(src[..., CHUNK * dr:CHUNK * dr + MP],
                          w[3 * dr + dc], acc)
    return torch.clamp_min(acc + BIAS, 0.0)


def project_reference(d: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """p = wp^T D (..., 32, 1920): the sum in float64, rounded to f32."""
    return (wp.double().t() @ d.double()).float()


def update_reference(r: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A copy of r with r[..., 128:2048] = bf16(f32(r) + p * 1e-3)."""
    r = r.clone()
    win = r[..., CHUNK:CHUNK + MP]
    r[..., CHUNK:CHUNK + MP] = (win.float() + p * CU).bfloat16()
    return r


def step_reference(r: torch.Tensor, we: torch.Tensor, wp: torch.Tensor,
                   wdw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor, torch.Tensor]:
    """One band step: (new r, E, D, p)."""
    e = expand_reference(r, we)
    d = depthwise_reference(e, wdw)
    p = project_reference(d, wp)
    return update_reference(r, p), e, d, p


@torch.no_grad()
def mbpipe_chain_reference(state: State, reps: int, chains: int
                           ) -> tuple[torch.Tensor, ...]:
    """Plain version of :func:`mbpipe_chain` (module docstring), in every
    mode: `sync` does not change the function."""
    _validate(state, reps, chains)
    r1, r2, we, wp, wdw = state
    rs, last = [r1, r2][:chains], []
    for q in range(chains):
        for _ in range(reps):
            rs[q], e, d, p = step_reference(rs[q], we, wp, wdw)
        last.append((e, d, p))
    r2 = rs[1] if chains == 2 else r2.clone()
    return (rs[0], r2, *(torch.stack(x, dim=-3) for x in zip(*last)))


def mbpipe_chain(state: State, reps: int, chains: int, sync: str = "own"
                 ) -> tuple[torch.Tensor, ...]:
    """`reps` band steps of `chains` chains as one CUDA kernel launch
    (csrc/probe_mbpipe.cu), one CTA a band, the chains' warps meeting at
    barriers as `sync` says (SYNCS; two chains only for other than "own"):
    (r1, r2, e, d, p), new tensors (module docstring).  Same contract as
    :func:`mbpipe_chain_reference`, which runs instead when the tensors lie
    on the CPU.  Any other device launches the kernel or raises: it takes
    contiguous tensors."""
    _validate(state, reps, chains, sync)
    r1, r2, we, wp, wdw = state
    if r1.device.type == "cpu":
        return mbpipe_chain_reference(state, reps, chains)
    require_cuda(r1.device)
    if not all(t.is_contiguous() for t in state):
        raise ValueError("r1, r2, we, wp and wdw must be contiguous")
    lead = tuple(r1.shape[:-2])
    bands = r1.shape[0] if lead else 1
    if bands >= 2 ** 31:
        raise ValueError(f"too many bands for the grid: {bands}")
    from denoise_gan_tpu_torch.ops._build import load_library

    rb = torch.stack([x.reshape(bands, NR, MB) for x in (r1, r2)[:chains]],
                     dim=1).contiguous()
    f32 = dict(dtype=torch.float32, device=r1.device)
    e = torch.empty((bands, chains, NE, MB), **f32)
    d = torch.empty((bands, chains, NE, MP), **f32)
    p = torch.empty((bands, chains, NR, MP), **f32)
    with torch.cuda.device(r1.device):    # the launch uses the current device
        err = load_library().dgt_probe_mbpipe(
            rb.data_ptr(), we.data_ptr(), wp.data_ptr(), wdw.data_ptr(),
            e.data_ptr(), d.data_ptr(), p.data_ptr(), bands, chains,
            SYNCS.index(sync), reps, BIAS, CU,
            torch.cuda.current_stream(r1.device).cuda_stream)
    if err:
        raise RuntimeError(f"dgt_probe_mbpipe launch failed: CUDA error {err}")
    launch_counts[mode_key(chains, sync)] += 1
    new2 = rb[:, 1].reshape(r2.shape).contiguous() if chains == 2 \
        else r2.clone()
    return (rb[:, 0].reshape(r1.shape).contiguous(), new2,
            e.reshape(lead + e.shape[1:]), d.reshape(lead + d.shape[1:]),
            p.reshape(lead + p.shape[1:]))


def expand_bound(r: torch.Tensor, we: torch.Tensor,
                 want: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |kernel E - expand_reference(r, we)| (want):
    32 * 2**-22 * (|we|^T |r|) for f32 sums of 32 exact products in the
    tensor cores' order (twice the round-to-nearest bound: their additions
    may truncate), and 2**-22 * |want| for the two sides' roundings of the
    sum and the bias.  float64."""
    scale = we.double().abs().t() @ r.double().abs()
    return NR * 2.0 ** -22 * scale + 2.0 ** -22 * want.double().abs()


def project_bound(d: torch.Tensor, wp: torch.Tensor,
                  want: torch.Tensor) -> torch.Tensor:
    """Per-element bound on |kernel p - project_reference(d, wp)| (want):
    f32 sums of the 3 x 192 exact products of the three bf16 pieces, as
    ``expand_bound``.  float64."""
    scale = wp.double().abs().t() @ d.double().abs()
    return 3 * NE * 2.0 ** -22 * scale + 2.0 ** -22 * want.double().abs()


def step_agreement(prev: State, out: tuple[torch.Tensor, ...]
                   ) -> dict[str, float | bool]:
    """A call's last step (out = (r1, r2, e, d, p)) against the plain
    version's pieces from the bands one step earlier (prev, a state):
    ``e_ratio`` and ``p_ratio``, the largest |error| over
    ``expand_bound`` of E from prev's bands and over ``project_bound`` of
    p from the call's own D (<= 1 holds), ``e_err`` and ``p_err`` those
    errors; ``d_equal``, D bit-identical to ``depthwise_reference`` of the
    call's own E; ``r_equal``, each new band bit-identical to
    ``update_reference`` of its band in prev and the call's own p (and r2
    unchanged with one chain)."""
    r1, r2, we, wp, wdw = prev
    new1, new2, e, d, p = out
    chains = e.shape[-3]
    res = dict(e_ratio=0.0, p_ratio=0.0, e_err=0.0, p_err=0.0,
               d_equal=True, r_equal=chains == 2 or torch.equal(new2, r2))
    for q, (r, new) in enumerate(((r1, new1), (r2, new2))[:chains]):
        eq, dq, pq = e[..., q, :, :], d[..., q, :, :], p[..., q, :, :]
        want_e, want_p = expand_reference(r, we), project_reference(dq, wp)
        for key, got, want, bound in (
                ("e", eq, want_e, expand_bound(r, we, want_e)),
                ("p", pq, want_p, project_bound(dq, wp, want_p))):
            err = (got.double() - want.double()).abs()
            res[f"{key}_ratio"] = max(res[f"{key}_ratio"], float(
                (err / bound.clamp_min(1e-300)).max()))
            res[f"{key}_err"] = max(res[f"{key}_err"], float(err.max()))
        res["d_equal"] &= torch.equal(depthwise_reference(eq, wdw), dq)
        res["r_equal"] &= torch.equal(update_reference(r, pq), new)
    return res


def check(state: State, reps: int, chains: int, sync: str = "own"
          ) -> dict[str, float | bool | int]:
    """The kernel in one mode on `state` (on a CUDA device) at `reps`
    steps, its last step held against the plain version's pieces from the
    kernel's own bands one step earlier (a launch of reps - 1 steps, or
    the state itself): ``step_agreement``'s dict plus ``launches``, the
    launch count's increase over the checked launch, and, where r1 and r2
    carry a band axis, ``bands_equal``: every band of the launch equal to
    that band launched alone.  Raises for a state off a CUDA device."""
    require_cuda(state[0].device)
    key = mode_key(chains, sync)
    before = launch_counts[key]
    out = mbpipe_chain(state, reps, chains, sync)
    torch.cuda.synchronize(out[0].device)
    launches = launch_counts[key] - before
    prev = state if reps == 1 else \
        mbpipe_chain(state, reps - 1, chains, sync)[:2] + state[2:]
    res = dict(step_agreement(prev, out), launches=launches)
    r1, r2, *w = state
    if r1.dim() == 3:
        res["bands_equal"] = all(
            torch.equal(x[b], y)
            for b in range(r1.shape[0])
            for x, y in zip(out, mbpipe_chain(
                (r1[b].contiguous(), r2[b].contiguous(), *w), reps, chains,
                sync)))
    return res


def ops(reps: int, chains: int, bands: int) -> tuple[int, int]:
    """(tensor-core flops, CUDA-core operations) of a call, the JAX step's
    work once a step: the expand 2 * 192 * 32 * 2176 and the project 2 *
    32 * 192 * 1920; the depthwise 9 multiply-adds (2 each) an output,
    bias and relu of E and D (2 each an element), the r update's multiply
    and add."""
    steps = reps * chains * bands
    tc = 2 * NE * NR * MB + 2 * NR * NE * MP
    cc = 18 * NE * MP + 2 * NE * MB + 2 * NE * MP + 2 * NR * MP
    return tc * steps, cc * steps


def n_bytes(chains: int, bands: int) -> int:
    """Bytes a call must move: the bands read and written once, the
    weights read once, E, D and p written once."""
    per = 2 * (2 * NR * MB) + 4 * (NE * MB + NE * MP + NR * MP)
    return chains * bands * per + 2 * (2 * NR * NE) + 4 * 9 * NE


def us_per_step(ms: float, reps: int, chains: int, bands: int) -> float:
    """us per band step over the card."""
    return ms * 1e3 / (reps * chains * bands)


@torch.no_grad()
def library_chain(state: State, reps: int, chains: int
                  ) -> tuple[torch.Tensor, ...]:
    """The steps through PyTorch calls, the kernel's yardstick: per step
    and chain ``torch.matmul`` in f32 for E and p (cuBLAS; the caller sets
    ``torch.backends.cuda.matmul.allow_tf32``), ``torch.roll`` and nine
    multiplies and adds for the depthwise, bias, relu and the r update
    elementwise; every band at once.  Returns the new (r1, r2)."""
    _validate(state, reps, chains)
    r1, r2, we, wp, wdw = state
    wet, wpt, w = we.float().t(), wp.float().t(), wdw[:, :, None]
    out = [r1.clone(), r2.clone()]
    for q in range(chains):
        r = out[q]
        for _ in range(reps):
            e = torch.clamp_min(torch.matmul(wet, r.float()) + BIAS, 0.0)
            srcs = (torch.roll(e, 1, -1), e, torch.roll(e, -1, -1))
            acc = torch.zeros(e.shape[:-1] + (MP,), dtype=e.dtype,
                              device=e.device)
            for dr in range(3):
                for dc, src in enumerate(srcs):
                    acc = acc + w[3 * dr + dc] * \
                        src[..., CHUNK * dr:CHUNK * dr + MP]
            p = torch.matmul(wpt, torch.clamp_min(acc + BIAS, 0.0))
            win = r[..., CHUNK:CHUNK + MP]
            r[..., CHUNK:CHUNK + MP] = (win.float() + p * CU).bfloat16()
    return out[0], out[1]


def _card_state(device: torch.device | str) -> State:
    """The initial state on one band per SM of the card."""
    dev = require_cuda(device)
    return band_state(initial_state(dev), torch.cuda.get_device_properties(
        dev).multi_processor_count)


def measure(device: torch.device | str = "cuda") -> dict[str, list[float]]:
    """ms of one launch of REPS steps in each of MODES (by
    ``mode_key``), one band per SM from the initial state: two readings a
    mode, the modes timed in order and then in reverse order (a card that
    warms up over the run favours none), each by CUDA events after a
    warm-up (the mean of TIMED launches, the wrapper's copies included)."""
    state = _card_state(device)
    out = {mode_key(c, s): [] for c, s in MODES}
    for order in (MODES, MODES[::-1]):
        for c, s in order:
            out[mode_key(c, s)].append(card.cuda_ms(
                lambda c=c, s=s: mbpipe_chain(state, REPS, c, s), TIMED))
    return out


def clocks(device: torch.device | str = "cuda") -> dict[str, str]:
    """Per mode, nvidia-smi's CLOCK_QUERY read while TIMED launches of
    REPS steps run on one band per SM."""
    state = _card_state(device)
    index = state[0].device.index or 0
    return {mode_key(c, s): card.smi_during(
        lambda c=c, s=s: [mbpipe_chain(state, REPS, c, s)
                          for _ in range(TIMED)],
        CLOCK_QUERY, index) for c, s in MODES}


def yardstick_ms(device: torch.device | str = "cuda") -> dict[str, float]:
    """One run each of the plain version and of ``library_chain`` (TF32
    off) on one band per SM from the initial state, LINE_REPS steps, per
    chain count: ms by key "plain:<chains>" and "library:<chains>"."""
    state = _card_state(device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for c in CHAINS:
            out[f"plain:{c}"] = card.cuda_ms(
                lambda c=c: mbpipe_chain_reference(state, LINE_REPS, c), 1)
            out[f"library:{c}"] = card.cuda_ms(
                lambda c=c: library_chain(state, LINE_REPS, c), 1)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def main(device: torch.device | str = "cuda") -> None:
    dev = require_cuda(device)
    peak, sms, _ = card.fp32_peak(dev)
    print(f"{card.smi('name,power.limit', dev.index or 0)}; {sms} bands "
          f"(one a CTA, one CTA an SM); FP32 peak {peak / 1e12:.2f} TF/s")
    ms = measure(dev)
    smi = clocks(dev)
    lines = yardstick_ms(dev)
    per = {}
    for c, sync in MODES:
        key = mode_key(c, sync)
        mean = sum(ms[key]) / len(ms[key])
        per[key] = us_per_step(mean, REPS, c, sms)
        print(f"{key}: {mean:.3f} ms for {REPS} steps (readings "
              f"{', '.join(f'{m:.3f}' for m in ms[key])}), {per[key]:.4f} "
              f"us/band step over the card (x {FRAME_STEPS} band steps of "
              f"the TPU geometry: {per[key] * FRAME_STEPS / 1e3:.3f} ms); "
              f"bound {ops(1, 1, 1)[1] / peak * 1e6:.4f} us (the CUDA-core "
              f"operations at the FP32 peak); while it runs {CLOCK_QUERY}: "
              f"{smi[key]}")
    for c in CHAINS:
        print(f"chains={c} at {LINE_REPS} steps: plain version "
              f"{us_per_step(lines[f'plain:{c}'], LINE_REPS, c, sms):.3f} us, "
              f"library calls "
              f"{us_per_step(lines[f'library:{c}'], LINE_REPS, c, sms):.3f} "
              f"us a band step")
    one, two = mode_key(1), mode_key(2)
    print(f"gain t1/t2: {per[one] / per[two]:.3f}x; aligned/offset: "
          f"{per[mode_key(2, 'aligned')] / per[mode_key(2, 'offset')]:.3f}x")


if __name__ == "__main__":
    main()
