"""The trainers' summaries (denoise_gan_tpu/utils/logging.py): one
timestamped run directory per run (``logs/{model_name}/train_{MMDD_HHMM}``),
scalars and uint8 image panels every ``save_iter`` steps.  Every scalar
goes to ``events.jsonl`` in the run directory; TensorBoard event files are
written as well where tensorboardX is importable."""

from __future__ import annotations

import json
import os
import time
from datetime import datetime
from typing import Any

import numpy as np


def timestamped_run_dir(logdir: str, model_name: str) -> str:
    short = datetime.now().strftime("%m%d_%H%M")
    return os.path.join(logdir, model_name, f"train_{short}")


class SummaryWriter:
    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        try:     # imported here: it takes ~2 s, and a run may not log
            from tensorboardX import SummaryWriter as TBWriter
        except ImportError:
            TBWriter = None
        self._tb = TBWriter(run_dir) if TBWriter is not None else None
        self._jsonl = open(os.path.join(run_dir, "events.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        value = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps(
            {"t": time.time(), "step": step, "tag": tag, "value": value}) + "\n")

    def scalars(self, values: dict[str, Any], step: int,
                prefix: str = "") -> None:
        for k, v in values.items():
            self.scalar(prefix + k, v, step)

    def image(self, tag: str, img_hwc_uint8: np.ndarray, step: int) -> None:
        if self._tb is not None:
            self._tb.add_image(tag, np.asarray(img_hwc_uint8), step,
                               dataformats="HWC")

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
        self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
