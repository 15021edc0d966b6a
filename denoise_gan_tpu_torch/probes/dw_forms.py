"""Depthwise-forms probe (K4): a chained 3x3 depthwise on a (192, 17 x 128)
f32 band, in four forms that differ in where the operands live.

Counterpart of tools/exp_dw_forms.py, which looked for the fastest Mosaic
form of the FSRGAN body's depthwise (192 channels, a 15 x 128-pixel band
step) for a fused body kernel.  Its state (``initial_state``) is the band
e (C, 2176) f32, 17 rows of 128 flattened, e[c, j] = f32(j) * 1e-4 -
f32(c) * 1e-4, and per-channel weights w (9, C), w[t, c] = f32(c) * 1e-4 +
0.05.  ``dw_chain(e, w, reps, form)`` runs `reps` reps of

* d (C, 1920) = sum over tap rows dr and columns dc of w[3 dr + dc] *
  src_dc[:, 128 dr : 128 dr + 1920], with src = (roll(e, 1), e, roll(e,
  -1)) on the flattened axis (a row's edge taps read the neighbouring row's
  edge value; the ends wrap); summed from 0 in that order, each step one
  multiply-add rounded once (``fma_f32``, as the kernel's fmaf);
* e[:, 0:128] = d[:, 0:128] * 1e-3 (rounded), which the next rep reads;

and returns (e, d), d of the last rep.  The forms (csrc/probe_dw.cu):
``scratch`` (rolled copies in shared memory), ``value`` (the rolls as
addresses into e's one buffer), ``chunked`` (a register window per
128-wide output chunk, the +-1 taps by warp shuffles that wrap inside the
chunk: the TPU form's function, which differs from the others at columns
0 and 127 of each output chunk) and ``planes`` (as scratch, each weight
read from a full plane in shared memory).  scratch, value and planes
compute one function; the plain version ``dw_chain_reference`` has two:
flat rolls, or rolls within each chunk for ``chunked``.

The wrapper launches the kernel for tensors on a CUDA device, where the
band must be 2176 wide, and raises otherwise; on tensors that lie on the
CPU it runs the plain version, bit-identical to the kernel.

    python -m denoise_gan_tpu_torch.probes.dw_forms     # on a CUDA GPU

prints each form's us per band step over REPS reps against the FP32 bound
and the shared-memory floor, scaled by the TPU geometry's 7119 band steps
a 1080p frame, and the same chain through ``F.conv2d(groups=C)``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from denoise_gan_tpu_torch.probes.fma_peak import fma_f32
from denoise_gan_tpu_torch.utils import card
from denoise_gan_tpu_torch.utils.device import require_cuda, resolve_device

NCH = 192                   # tools/exp_dw_forms.py:30
CHUNK = 128                 # a band row
MB = 17 * CHUNK             # :31
MP = 15 * CHUNK             # :32
REPS = 2000                 # :146
FORMS = ("scratch", "value", "chunked", "planes")   # :92
FRAME_STEPS = 7119          # the TPU geometry's band steps a 1080p frame
C_UPD = float(np.float32(1e-3))                     # :111
TIMED = 5                   # timed launches after a warm-up

# Plain integers: the kernel's launches, by form.
launch_counts = {f"dw_chain:{f}": 0 for f in FORMS}


def initial_state(device: torch.device | str = "cuda", nch: int = NCH
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(e (nch, MB), w (9, nch)) of the JAX probe (:97-98) as its
    expressions read, each operation rounded to f32 (XLA's CPU backend
    contracts e's subtraction with one product, 1 ulp apart in places)."""
    dev = resolve_device(device)
    f1e4 = np.float32(1e-4)
    ch = np.arange(nch, dtype=np.float32)
    e = np.arange(MB, dtype=np.float32)[None, :] * f1e4 - ch[:, None] * f1e4
    w = np.broadcast_to(ch * f1e4 + np.float32(0.05), (9, nch))
    return (torch.from_numpy(np.ascontiguousarray(e)).to(dev),
            torch.from_numpy(np.ascontiguousarray(w)).to(dev))


def _check(e: torch.Tensor, w: torch.Tensor, reps: int, form: str) -> None:
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if e.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"e and w must be float32, got {e.dtype} and "
                         f"{w.dtype}")
    if e.dim() != 2 or e.shape[0] < 1 or e.shape[1] != MB or \
            tuple(w.shape) != (9, e.shape[0]):
        raise ValueError(f"e must be (C, {MB}) and w (9, C), got "
                         f"{tuple(e.shape)} and {tuple(w.shape)}")
    if e.device != w.device:
        raise ValueError(f"e on {e.device}, w on {w.device}")
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")


def _taps(e: torch.Tensor, dr: int, form: str) -> list[torch.Tensor]:
    """(left, centre, right) sources (C, MP) of tap row dr."""
    src = e[:, dr * CHUNK:dr * CHUNK + MP]
    if form == "chunked":
        c = src.reshape(e.shape[0], -1, CHUNK)
        return [torch.roll(c, 1, 2).reshape_as(src), src,
                torch.roll(c, -1, 2).reshape_as(src)]
    return [torch.roll(e, 1, 1)[:, dr * CHUNK:dr * CHUNK + MP], src,
            torch.roll(e, -1, 1)[:, dr * CHUNK:dr * CHUNK + MP]]


@torch.no_grad()
def dw_chain_reference(e: torch.Tensor, w: torch.Tensor, reps: int,
                       form: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`dw_chain` (module docstring)."""
    _check(e, w, reps, form)
    e, wc = e.clone(), w[:, :, None]
    for _ in range(reps):
        d = torch.zeros((e.shape[0], MP), dtype=e.dtype, device=e.device)
        for dr in range(3):
            for dc, src in enumerate(_taps(e, dr, form)):
                d = fma_f32(src, wc[3 * dr + dc], d)
        e[:, :CHUNK] = d[:, :CHUNK] * C_UPD
    return e, d


def dw_chain(e: torch.Tensor, w: torch.Tensor, reps: int,
             form: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The chain as one CUDA kernel launch (csrc/probe_dw.cu) of the given
    form from (e, w): (e, d) after `reps` reps, e a new tensor.  Same
    contract as :func:`dw_chain_reference`, which runs instead when the
    tensors lie on the CPU.  Any other device launches the kernel or
    raises: it takes contiguous e and w, one CTA a channel."""
    _check(e, w, reps, form)
    if e.device.type == "cpu":
        return dw_chain_reference(e, w, reps, form)
    require_cuda(e.device)
    if not e.is_contiguous() or not w.is_contiguous():
        raise ValueError("e and w must be contiguous")
    if e.shape[0] >= 2 ** 31:
        raise ValueError(f"too many channels for the grid: {e.shape[0]}")
    from denoise_gan_tpu_torch.ops._build import load_library

    e = e.clone()
    d = torch.empty((e.shape[0], MP), dtype=e.dtype, device=e.device)
    with torch.cuda.device(e.device):     # the launch uses the current device
        err = load_library().dgt_probe_dw(
            e.data_ptr(), w.data_ptr(), d.data_ptr(), e.shape[0], reps,
            FORMS.index(form), C_UPD,
            torch.cuda.current_stream(e.device).cuda_stream)
    if err:
        raise RuntimeError(f"dgt_probe_dw launch failed: CUDA error {err}")
    launch_counts[f"dw_chain:{form}"] += 1
    return e, d


def ops(reps: int) -> int:
    """Flops of `reps` reps at NCH channels: 9 multiply-adds an output."""
    return 18 * NCH * MP * reps


def n_bytes() -> int:
    """Bytes a call at NCH channels must move: e read and written once, w
    read once, d written once."""
    return 4 * (2 * NCH * MB + 9 * NCH + NCH * MP)


def smem_floor_ms(form: str, sms: int, mhz: float) -> float:
    """One band step's floor at NCH channels: the taps' shared-memory reads
    (4 bytes a tap an output; twice that with the weight planes) at 128
    bytes a clock an SM on every SM."""
    per_tap = 8 if form == "planes" else 4
    return 9 * per_tap * NCH * MP / (128 * sms * mhz * 1e6) * 1e3


def _extended(e: torch.Tensor, form: str) -> torch.Tensor:
    """The band as (1, C, 17, 130): each row with one more column on each
    side, from the flattened neighbours (or the row's own other end, for
    ``chunked``), so that a valid 3x3 convolution gives d."""
    rows = e.reshape(1, e.shape[0], -1, CHUNK)
    if form == "chunked":
        left, right = rows[..., -1:], rows[..., :1]
    else:
        left = torch.roll(e, 1, 1).reshape_as(rows)[..., :1]
        right = torch.roll(e, -1, 1).reshape_as(rows)[..., -1:]
    return torch.cat([left, rows, right], dim=3)


@torch.no_grad()
def library_chain(e: torch.Tensor, w: torch.Tensor, reps: int,
                  form: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The chain through PyTorch calls, the kernel's yardstick: each rep
    the extended band (``_extended``), one ``F.conv2d(groups=C)`` (cuDNN;
    the caller sets ``torch.backends.cudnn.allow_tf32``) and the chunk-0
    update.  Sums in cuDNN's order."""
    _check(e, w, reps, form)
    e = e.clone()
    kernel = w.t().reshape(e.shape[0], 1, 3, 3).contiguous()
    for _ in range(reps):
        d = F.conv2d(_extended(e, form), kernel,
                     groups=e.shape[0]).reshape(e.shape[0], MP)
        e[:, :CHUNK] = d[:, :CHUNK] * C_UPD
    return e, d


def measure(device: torch.device | str = "cuda") -> dict[str, float]:
    """Each form's ms per launch of REPS reps from the initial state, by
    CUDA events after a warm-up (the mean of TIMED launches, the wrapper's
    copy of e included)."""
    dev = require_cuda(device)
    e, w = initial_state(dev)
    return {form: card.cuda_ms(lambda form=form: dw_chain(e, w, REPS, form),
                               TIMED) for form in FORMS}


def library_ms(device: torch.device | str = "cuda") -> dict[str, float]:
    """Each form's ``library_chain`` ms over REPS reps from the initial
    state (one run after a warm-up), with cuDNN's TF32 off."""
    dev = require_cuda(device)
    e, w = initial_state(dev)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return {form: card.cuda_ms(
            lambda form=form: library_chain(e, w, REPS, form), 1)
            for form in FORMS}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def main(device: torch.device | str = "cuda") -> None:
    dev = require_cuda(device)
    peak, sms, mhz = card.fp32_peak(dev)
    print(f"{card.smi('name,power.limit', dev.index or 0)}; FP32 peak "
          f"{peak / 1e12:.2f} TF/s")
    bound_us = ops(1) / peak * 1e6
    lib = library_ms(dev)
    for form, ms in measure(dev).items():
        us = ms / REPS * 1e3
        print(f"{form}: {us:.3f} us/band step over {REPS} reps (x "
              f"{FRAME_STEPS} band steps of the TPU geometry: "
              f"{us * FRAME_STEPS / 1e3:.2f} ms); bound {bound_us:.3f} us "
              f"(operations), shared-memory floor "
              f"{smem_floor_ms(form, sms, mhz) * 1e3:.3f} us; "
              f"F.conv2d chain {lib[form] / REPS * 1e3:.3f} us/step")


if __name__ == "__main__":
    main()
