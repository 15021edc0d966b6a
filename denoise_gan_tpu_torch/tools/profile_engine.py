"""A torch.profiler trace of a kernel engine at 1080p, its device events
grouped by name (tools/profile_engine.py).

Build the engine, run one frame outside the trace, trace N frames (two
seeded frames, alternating; synchronised inside the trace), then group
the trace's device events by name and print ms per frame, ranked: where
a frame's time goes, kernel by kernel.  The arguments are the JAX tool's,
``[fsrgan|srgan] [bf16|q8] [n_frames]`` (``q8`` is w8a8, as there), and
also ``qh8``, ``--body k3`` (FSRGAN's inverted residuals as the fused
kernel K3, infer/kernel_engine.py::prepare_mbconv_fsrgan_engine),
``--model`` (an export; by default the port's build_generator weights,
seed 0), ``--device`` (the card unless ``cpu`` is asked for; there the
engines run their kernels' plain versions) and ``--trace_dir`` (the
Chrome trace is kept there; by default it goes to a temporary directory
that is removed)::

    python3 -m denoise_gan_tpu_torch.tools.profile_engine fsrgan q8 6 \\
        [--body k3] [--model m.dgt] [--device cuda] [--trace_dir prof]

The trace is written where the JAX tool's parser looks,
``<trace_dir>/plugins/profile/<run>/<host>.trace.json.gz``, and
``parse_trace`` prints the JAX tool's table.  Its device lanes are the
processes named or labelled as a GPU or a device, and those of the
kernel, copy and set events; with none, every complete event counts, as
the JAX tool falls back to.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import shutil
import socket
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from denoise_gan_tpu_torch.infer import kernel_engine as ke
from denoise_gan_tpu_torch.io.checkpoint import load_generator
from denoise_gan_tpu_torch.models import build_generator
from denoise_gan_tpu_torch.utils.device import resolve_device

HEIGHT, WIDTH = 1080, 1920
MODES = {"bf16": "bf16", "q8": "w8a8", "qh8": "qh8"}
TOP = 25                       # rows printed
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the CPU's ranges drawn on the device's timeline: not device time
PROJECTED_CATS = ("gpu_user_annotation",)


def parse_trace(trace_dir: str, n_frames: int) -> dict | None:
    """Group the newest trace under `trace_dir` by event name and print
    the JAX tool's table: the device total and ms per frame, then the
    TOP largest rows as ms per frame, count and name.  Returns {"path",
    "total_ms", "rows": [(name, ms, count)] largest first, all of them},
    or None where no trace is found."""
    paths = glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.trace.json.gz"))
    if not paths:
        print("no trace found under", trace_dir)
        return None
    path = max(paths, key=os.path.getmtime)
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", [])
    device_pids = set()
    for e in events:
        if e.get("ph") == "M" and e.get("name") in ("process_name",
                                                    "process_labels"):
            label = " ".join(str(v) for v in e.get("args", {}).values())
            if "GPU" in label.upper() or "device" in label.lower():
                device_pids.add(e["pid"])
        elif e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            device_pids.add(e["pid"])
    agg = defaultdict(float)
    cnt = defaultdict(int)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") in PROJECTED_CATS:
            continue
        if device_pids and e.get("pid") not in device_pids:
            continue
        agg[e["name"]] += e.get("dur", 0) / 1e3      # us -> ms
        cnt[e["name"]] += 1
    total = sum(agg.values())
    rows = sorted(agg.items(), key=lambda kv: -kv[1])
    print(f"\ntrace {os.path.basename(path)}: {total:.1f} ms device total, "
          f"{total/n_frames:.1f} ms/frame over {n_frames} frames")
    print(f"{'ms/frame':>9}  {'count':>5}  name")
    for name, ms in rows[:TOP]:
        print(f"{ms/n_frames:9.2f}  {cnt[name]:5d}  {name[:90]}")
    return {"path": path, "total_ms": total,
            "rows": [(name, ms, cnt[name]) for name, ms in rows]}


def build_engine(model: torch.nn.Module, family: str, mode: str, body: str,
                 height: int, width: int, calib: torch.Tensor):
    """The kernel engine of `family` in `mode` (bf16, q8 = w8a8, qh8;
    the int8 modes calibrated on `calib`), with the plain body or
    (FSRGAN) the K3 body."""
    kw = {} if mode == "bf16" else dict(q8_calib_frame=calib,
                                         qh8=mode == "qh8")
    if body == "k3":
        if family != "fsrgan":
            raise ValueError("--body k3 is FSRGAN's (its inverted "
                             f"residuals), not {family}'s")
        b, tw, brc = ke.prepare_mbconv_fsrgan_engine(model, height, width,
                                                     **kw)
        return ke.build_kernel_engine(b, tw, height, width, brc=brc)
    build = (ke.build_fsrgan_kernel_engine if family == "fsrgan"
             else ke.build_srgan_kernel_engine)
    return build(model, height, width, **kw)


def profile(family: str = "fsrgan", mode: str = "q8", n_frames: int = 6,
            body: str = "plain", model: torch.nn.Module | str | None = None,
            device: torch.device | str = "cuda", height: int = HEIGHT,
            width: int = WIDTH, trace_dir: str = "") -> dict | None:
    """Trace `n_frames` of the engine (see the module docstring) on a
    `height` x `width` frame and parse the trace (``parse_trace``'s
    result).  `model` is a generator, an export's path, or None (the
    port's weights, seed 0).  The trace stays under `trace_dir` when one
    is given."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {sorted(MODES)}")
    if n_frames < 1:
        raise ValueError(f"{n_frames} frames to trace: at least 1")
    dev = resolve_device(device)
    if isinstance(model, str):
        config, model = load_generator(model, device=dev)
        if config["family"] != family:
            raise ValueError(f"the export is {config['family']}'s, not "
                             f"{family}'s")
    elif model is None:
        model = build_generator(family, device=dev,
                                generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    frames = [torch.from_numpy(rng.random((height, width, 3)).astype(
        np.float32)).to(dev) for _ in range(2)]
    engine = build_engine(model, family, mode, body, height, width,
                          frames[0])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    engine(frames[0])                     # first calls outside the trace
    sync()
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    keep = bool(trace_dir)
    trace_dir = trace_dir or tempfile.mkdtemp(prefix=f"prof_{family}_"
                                                     f"{mode}_")
    try:
        with torch_profile(activities=activities) as prof:
            for i in range(n_frames):
                out = engine(frames[i % 2])
            sync()
        run = os.path.join(trace_dir, "plugins", "profile",
                           time.strftime("%Y_%m_%d_%H_%M_%S"))
        os.makedirs(run, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            run, f"{socket.gethostname()}.trace.json.gz"))
        if out.shape != (4 * height, 4 * width, 3):
            raise AssertionError(f"the engine gave {tuple(out.shape)}")
        return parse_trace(trace_dir, n_frames)
    finally:
        if not keep:
            shutil.rmtree(trace_dir, ignore_errors=True)


def main(argv: list[str] | None = None, height: int = HEIGHT,
         width: int = WIDTH) -> int:
    p = argparse.ArgumentParser(
        description="Trace a kernel engine and rank its device events")
    p.add_argument("family", nargs="?", default="fsrgan",
                   choices=["fsrgan", "srgan"])
    p.add_argument("mode", nargs="?", default="q8", choices=list(MODES))
    p.add_argument("n_frames", nargs="?", type=int, default=6)
    p.add_argument("--body", default="plain", choices=["plain", "k3"])
    p.add_argument("--model", default="",
                   help="a .dgt or .h5 export (default: the port's "
                        "build_generator weights, seed 0)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--trace_dir", default="",
                   help="keep the Chrome trace here (default: a temporary "
                        "directory, removed)")
    args = p.parse_args(argv)
    print(f"profile_engine: {args.family} {MODES[args.mode]} "
          f"({args.body} body) at {height}x{width}, {args.n_frames} frames "
          f"on {args.device}")
    profile(args.family, args.mode, args.n_frames, args.body,
            args.model or None, args.device, height, width, args.trace_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
