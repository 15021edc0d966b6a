"""Tracing and step timing for the trainers (denoise_gan_tpu/utils/
profiling.py): a torch.profiler trace of a block, a StepTimer giving
steps/s and images/s without the first (warm-up) step, and a guard that
raises on NaN or Inf losses."""

from __future__ import annotations

import contextlib
import math
import os
import time

import torch


@contextlib.contextmanager
def trace(profile_dir: str | None):
    """A torch.profiler trace (CPU, and CUDA where the card is in use) of
    the block, written as a Chrome trace under `profile_dir`; a no-op
    when `profile_dir` is empty."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace_{time.strftime('%m%d_%H%M%S')}.json"))


class StepTimer:
    """steps/s and images/s since the first tick: the first step (the
    warm-up: cuDNN's algorithm choice, allocations) is not counted.  The
    caller synchronises the device before reading the rates."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.reset()

    def reset(self) -> None:
        self._t0 = None
        self._steps = 0

    def tick(self) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()
            return
        self._steps += 1

    @property
    def steps(self) -> int:
        return self._steps

    @property
    def steps_per_sec(self) -> float:
        if not self._steps or self._t0 is None:
            return 0.0
        return self._steps / max(time.perf_counter() - self._t0, 1e-9)

    @property
    def images_per_sec(self) -> float:
        return self.steps_per_sec * self.batch_size


def check_finite(metrics: dict, step: int) -> None:
    """Raise FloatingPointError on a NaN or Inf metric."""
    for k, v in metrics.items():
        v = float(v)
        if not math.isfinite(v):
            raise FloatingPointError(
                f"non-finite metric {k}={v} at step {step}; "
                "inspect inputs/LR or restore the last checkpoint")
