"""u8 phase-store probe (K10): the tails' u8 epilogue alone.

Counterpart of tools/exp_u8_store.py, which asked how the TPU stores uint8
and extracts the four 12-column phases of a (rows, 48) block by lane rolls
for the fused tail's epilogue.  From res (M, 48) f32:

    u8 = trunc(clip((tanh(res) + 1) * 0.5, 0, 1) * 255 + 0.5)
    out[b, eo, r, c] = u8[128 b + r, 12 eo + c]       # (M / 128, 4, 128, 12)

(the probe's own reference, :37-38), for any M that is a multiple of 128.
``u8_phase_store`` launches the CUDA kernel of csrc/probe_u8.cu; on a
tensor that lies on the CPU it runs the plain version,
``u8_phase_store_reference``: torch ops that round each step apart, as the
kernel does, with the same tanh on the card (tanhf), so the two agree bit
for bit there.

    python -m denoise_gan_tpu_torch.probes.u8_store     # on a CUDA GPU

times the kernel at the JAX probe's (1024, 48) and at a 4K frame's worth,
FRAME_4K_ROWS rows (3840 x 2160 x 3 bytes out), against its bound.
"""

from __future__ import annotations

import numpy as np
import torch

from denoise_gan_tpu_torch.ops.tail import _tanh
from denoise_gan_tpu_torch.utils import card
from denoise_gan_tpu_torch.utils.device import require_cuda

ROWS = 1024                       # tools/exp_u8_store.py:27
BAND, PHASES, PHASE_COLS = 128, 4, 12   # :23, the (8, 4, 128, 12) store
COLS = PHASES * PHASE_COLS        # 48
FRAME_4K_ROWS = 3840 * 2160 * 3 // COLS   # 518,400
TIMED = 20                        # timed launches after a warm-up

# Plain integer: the kernel's launches.
launch_counts = {"u8_phase_store": 0}


def _check(res: torch.Tensor) -> int:
    """The bands of a valid input; raises ValueError."""
    if res.dtype != torch.float32 or res.dim() != 2 or res.shape[1] != COLS \
            or res.shape[0] < BAND or res.shape[0] % BAND:
        raise ValueError(f"res must be (M, {COLS}) float32 with M a "
                         f"multiple of {BAND}, got {res.dtype} "
                         f"{tuple(res.shape)}")
    return res.shape[0] // BAND


@torch.no_grad()
def u8_phase_store_reference(res: torch.Tensor) -> torch.Tensor:
    """Plain version: (M / 128, 4, 128, 12) uint8 (module docstring), tanh
    single-threaded on the CPU (ops/tail.py::_tanh)."""
    bands = _check(res)
    v = ((_tanh(res) + 1) * 0.5).clamp(0, 1) * 255 + 0.5
    return v.to(torch.uint8).reshape(bands, BAND, PHASES, PHASE_COLS) \
        .permute(0, 2, 1, 3).contiguous()


def u8_phase_store(res: torch.Tensor) -> torch.Tensor:
    """The u8 store as one CUDA kernel launch (csrc/probe_u8.cu); same
    contract as :func:`u8_phase_store_reference`, which runs instead when
    res lies on the CPU.  Any other device launches the kernel or raises:
    it takes contiguous, 16-byte aligned (M, 48) float32 res."""
    bands = _check(res)
    if res.device.type == "cpu":
        return u8_phase_store_reference(res)
    require_cuda(res.device)
    if not res.is_contiguous() or res.data_ptr() % 16:
        raise ValueError("res must be contiguous and 16-byte aligned")
    from denoise_gan_tpu_torch.ops._build import load_library

    out = torch.empty((bands, PHASES, BAND, PHASE_COLS), dtype=torch.uint8,
                      device=res.device)
    with torch.cuda.device(res.device):
        err = load_library().dgt_probe_u8_store(
            res.data_ptr(), out.data_ptr(), bands,
            torch.cuda.current_stream(res.device).cuda_stream)
    if err:
        raise RuntimeError(f"dgt_probe_u8_store launch failed: CUDA error "
                           f"{err}")
    launch_counts["u8_phase_store"] += 1
    return out


def seeded_input(device: torch.device | str = "cuda",
                 rows: int = ROWS, seed: int = 0) -> torch.Tensor:
    """The JAX probe's res (:28-29): standard normal f32 from
    ``np.random.default_rng(seed)``."""
    x = np.random.default_rng(seed).standard_normal((rows, COLS))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def frame_input(device: torch.device | str = "cuda",
                seed: int = 0) -> torch.Tensor:
    """A 4K frame's res, FRAME_4K_ROWS x 48 standard normal f32, drawn on
    the device from a torch.Generator seeded with `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((FRAME_4K_ROWS, COLS), generator=gen, device=device)


def n_bytes(rows: int) -> int:
    """Bytes the store must move: rows x 48 f32 read, rows x 48 u8
    written."""
    return rows * COLS * 5


def measure(device: torch.device | str = "cuda") -> list[dict]:
    """The kernel's ms per launch by CUDA events after a warm-up, queued
    behind a device sleep (``card.queued_ms``: the wrapper's host time is
    not counted; TIMED launches) at ROWS and FRAME_4K_ROWS rows, with GB/s
    of n_bytes."""
    dev = require_cuda(device)
    rows = []
    for res in (seeded_input(dev), frame_input(dev)):
        ms = card.queued_ms(lambda: u8_phase_store(res), TIMED)
        m = res.shape[0]
        rows.append(dict(rows=m, ms=ms, gbs=n_bytes(m) / ms / 1e6))
    return rows


def main(device: torch.device | str = "cuda") -> None:
    dev = require_cuda(device)
    print(card.smi("name,power.limit", dev.index or 0))
    for r in measure(dev):
        print(f"u8_phase_store ({r['rows']}, {COLS}) f32: {r['ms']:.4f} ms, "
              f"{r['gbs']:.0f} GB/s of {n_bytes(r['rows']) / 1e6:.1f} MB")


if __name__ == "__main__":
    main()
