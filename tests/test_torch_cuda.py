"""The fused tail CUDA kernel (csrc/tail.cu) against its plain PyTorch twin on
the card, at small and ragged geometries that chip_smoke.py's 1080p shapes do
not reach: core_rows not a multiple of the kernel's 5-row band, and frames
that end inside the last tile row and column.

These tests need a CUDA GPU and nvcc; without them they skip.  tests/
conftest.py imports jax and hides CUDA devices, so on a machine with a card
run them without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

The port runs in a child process (tests/torch_process.py).  Bound as
chip_smoke.py's: max |du8| <= 1 on < 1e-3 of the bytes (the two sum in
different orders).
"""

import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

pytestmark = pytest.mark.gpu

# (ny, nx, core_rows, height, width)
GEOMETRIES = [
    (1, 2, 24, 24, 240),      # frame = grid, band does not divide core_rows
    (2, 3, 24, 41, 301),      # ragged bottom and right edges
    (1, 1, 7, 5, 100),        # one tile, fewer core rows than a band
]


@pytest.fixture(scope="module")
def port():
    with torch_process() as call:
        if not call("cuda_available"):
            pytest.skip("needs a CUDA GPU (and nvcc to build csrc/)")
        yield call


@pytest.mark.parametrize("bgr", [False, True], ids=["rgb", "bgr"])
@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_kernel_matches_twin(port, geom, mode, bgr):
    ny, nx, cr, height, width = geom
    r = port("cuda_kernel_vs_twin", ny, nx, cr, height, width, mode, bgr)
    assert r["shape"] == r["want_shape"] == (4 * height, 4 * width, 3)
    assert r["dtype"] == "torch.uint8" and r["device"] == "cuda"
    assert r["launches"] == 1
    assert r["max_diff"] <= 1 and r["frac_diff"] < 1e-3, r
    assert r["std_min"] > 5                    # not a flat frame
