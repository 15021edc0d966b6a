"""A data-parallel dry run of the trainer on one machine
(tools/dryrun_multihost.py and __graft_entry__.py::dryrun_multichip, for
the port):

    python -m denoise_gan_tpu_torch.parallel.dryrun [--device cpu]
        [--nproc 2] [--family fsrgan] [--workdir DIR]

writes 9 seeded 48x48 images (so that the ranks' file shards are
unequal, 5 and 4 with two ranks), then runs ``train_<family>_torch.py``
under ``torchrun --standalone --nproc_per_node <nproc>`` (a free port,
gloo: ranks on the CPU, or sharing the card ``--device cuda:0``) for one
global step at crop 32, ``--batch_size 8`` (the host's batch, 4 a rank
with two ranks).  It asserts that every rank exits 0 with finite losses and the
same parameter checksum, and that one rank alone wrote the run's
files (one TensorBoard run, the exports).  Exit code 0 and a last line
``dryrun ok: ...`` when it holds.
"""

from __future__ import annotations

import argparse
import math
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
IMAGES, SIZE, CROP, BATCH = 9, 48, 32, 8
CHECKSUM = re.compile(r"rank (\d+) of (\d+): parameter checksum (\S+)")
LOSSES = re.compile(r"disc_loss: (\S+), adv_loss: (\S+), vgg: (\S+), "
                    r"mse: (\S+), mae: (\S+),")


def write_images(data_dir: Path, seed: int = 0) -> None:
    """IMAGES seeded uint8 RGB .npy images under data_dir/cls."""
    d = data_dir / "cls"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(IMAGES):
        np.save(d / f"im{i}.npy",
                (rng.random((SIZE, SIZE, 3)) * 255).astype(np.uint8))


def trainer_argv(family: str, device: str, data_dir: Path) -> list[str]:
    return [str(REPO / f"train_{family}_torch.py"), "--device", device,
            "--image_dir", str(data_dir), "--epochs", "1",
            "--batch_size", str(BATCH), "--crop_size", str(CROP),
            "--save_iter", "1", "--retrain", "0", "--log_images", "0",
            "--data_workers", "2", "--model_name", f"dryrun_{family}"]


def run(device: str = "cpu", nproc: int = 2, family: str = "fsrgan",
        workdir: str | None = None, timeout_s: float = 600) -> dict:
    """The dry run (see the module docstring); its readings, or
    AssertionError / CalledProcessError / TimeoutExpired."""
    work = Path(workdir or tempfile.mkdtemp(prefix="dgt_dryrun_"))
    work.mkdir(parents=True, exist_ok=True)
    write_images(work / "data")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nnodes", "1", "--nproc_per_node", str(nproc),
           *trainer_argv(family, device, work / "data")]
    proc = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                          text=True, timeout=timeout_s)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise AssertionError(f"torchrun exited {proc.returncode}:\n"
                             + log[-6000:])
    sums = {int(r): float(c) for r, n, c in CHECKSUM.findall(proc.stdout)
            if int(n) == nproc}
    if sorted(sums) != list(range(nproc)):
        raise AssertionError(f"checksums of ranks {sorted(sums)}, not of "
                             f"0..{nproc - 1}:\n{log[-4000:]}")
    if len(set(sums.values())) != 1:
        raise AssertionError(f"the ranks' parameters differ: {sums}")
    losses = [tuple(float(v) for v in m) for m in
              LOSSES.findall(proc.stdout)]
    if len(losses) != nproc or not all(math.isfinite(v) for m in losses
                                       for v in m):
        raise AssertionError(f"losses {losses}:\n{log[-4000:]}")
    if len(set(losses)) != 1:
        raise AssertionError(f"the ranks report different losses: "
                             f"{losses}")
    runs = list((work / "logs").iterdir())
    exports = sorted(p.name for p in (work / "models").glob("*.dgt"))
    if len(runs) != 1 or len(exports) != 2:
        raise AssertionError(f"files written: logs {runs}, exports "
                             f"{exports}")
    return {"ranks": nproc, "checksum": sums[0], "disc_loss": losses[0][0],
            "adv_loss": losses[0][1], "workdir": str(work)}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cpu",
                   help="cpu, or a card the ranks share (cuda:0)")
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--family", default="fsrgan")
    p.add_argument("--workdir", default=None)
    a = p.parse_args(argv)
    r = run(a.device, a.nproc, a.family, a.workdir)
    print(f"dryrun ok: {r['ranks']} ranks on {a.device}, disc_loss "
          f"{r['disc_loss']:.6g}, adv_loss {r['adv_loss']:.6g}, parameter "
          f"checksum {r['checksum']!r} on every rank, files in "
          f"{r['workdir']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
