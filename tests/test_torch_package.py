"""The PyTorch port stands alone: no module of denoise_gan_tpu_torch imports
jax, flax or the JAX package, and the package runs with jax unimportable."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_process import skip_without_torch

skip_without_torch()

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "denoise_gan_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "orbax", "denoise_gan_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources():
    """The package, chip_smoke.py, and the test helpers that run the port's
    side of the tests (they must import on a machine without jax)."""
    return sorted(PKG.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "torch_process.py",
        REPO / "tests" / "torch_side.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN and
           not m.startswith("denoise_gan_tpu_torch")]
    assert not bad, f"{path} imports {bad}"


def test_package_runs_without_jax(tmp_path):
    """Import every module and run the tail twin on the CPU in a process
    where ``import jax`` fails."""
    code = """
import sys
for name in ("jax", "flax", "jaxlib", "denoise_gan_tpu"):
    sys.modules[name] = None
import importlib, pkgutil
import torch
import denoise_gan_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from denoise_gan_tpu_torch.models import build_generator
from denoise_gan_tpu_torch.infer.kernel_engine import build_fsrgan_kernel_engine
model = build_generator("fsrgan", generator=torch.Generator().manual_seed(0))
out = build_fsrgan_kernel_engine(model, 20, 30, brc=24)(torch.rand(20, 30, 3))
assert out.shape == (80, 120, 3) and out.dtype == torch.uint8
assert not any(m.split(".")[0] in ("jax", "flax") and sys.modules[m] is not None
               for m in sys.modules)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")

