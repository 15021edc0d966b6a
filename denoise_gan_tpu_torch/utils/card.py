"""What is read from the card: its nvidia-smi name and power limit (and
clocks or power read while kernels run), its FP32 peak, and CUDA-event
timings (chip_smoke.py and the probes)."""

from __future__ import annotations

import subprocess
from typing import Callable

import torch

# FP32 lanes per SM at compute capability 9.0 (CUDA C++ Programming Guide)
FP32_LANES = 128
# queued_ms's device sleep: ~20 ms at the H100's ~2 GHz SM clock
_QUEUE_SLEEP_CYCLES = 40_000_000


def smi(query: str, index: int = 0) -> str:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader`` of card
    `index`."""
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), f"--query-gpu={query}",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def smi_during(fn: Callable[[], object], query: str, index: int = 0) -> str:
    """``smi(query, index)`` read while the kernels that fn() enqueues run:
    their device time must outlast nvidia-smi's start (a few tenths of a
    second)."""
    torch.cuda.synchronize()
    fn()
    try:
        return smi(query, index)
    finally:
        torch.cuda.synchronize()


def fp32_peak(device: torch.device) -> tuple[float, int, float]:
    """(FLOP/s, SMs, clocks.max.sm in MHz): SMs x 128 lanes x 2 flops x the
    card's maximum SM clock."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = float(smi("clocks.max.sm", device.index or 0).split()[0])
    return sms * FP32_LANES * 2 * mhz * 1e6, sms, mhz


def cuda_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean ms of fn() over reps calls, by CUDA events, after one warm-up."""
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


def queued_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean ms of fn() over reps calls by CUDA events, after one warm-up,
    with the calls queued behind a device-side sleep of _QUEUE_SLEEP_CYCLES
    clocks: the host enqueues them while the device sleeps, so its time
    between launches, which can exceed a short kernel's, is not counted
    (as long as reps launches take the host less than the sleep)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(_QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_chained(fn: Callable[[torch.Tensor], torch.Tensor],
                 x0: torch.Tensor, n: int = 32) -> float:
    """Mean ms per call of n chained calls x = fn(x), each taking the last
    one's output, by CUDA events after one warm-up call (the JAX probes'
    ``time_chained``, tools/exp_vpu_peak.py:24)."""
    x = fn(x0)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        x = fn(x)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n
