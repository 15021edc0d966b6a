"""The fused tail CUDA kernels (csrc/tail.cu for FSRGAN, csrc/tail_srgan.cu
for SRGAN) against their plain PyTorch twins on the card, at small and ragged
geometries that chip_smoke.py's 1080p shapes do not reach: core_rows not a
multiple of the kernels' 5-row band, and frames that end inside the last tile
row and column.  Likewise the fused inverted residual (csrc/mbconv.cu, K3)
against its plain version, bit for bit, at heights that its 8-row band and
widths that its 16-column chunk do not divide, with be > 0 so that the
zero ring of the expanded tensor is exercised.

These tests need a CUDA GPU and nvcc; without them they skip.  tests/
conftest.py imports jax and hides CUDA devices, so on a machine with a card
run them without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

The port runs in a child process (tests/torch_process.py).  Bound as
chip_smoke.py's: max |du8| <= 1 on < 1e-3 of the bytes (the two sum in
different orders).  In w8a8 mode every sum after up1 is an exact integer and
up1 sums in the twin's order, so kernel and twin agree byte for byte; for
FSRGAN that includes the output-conv taps that read R quantised from bf16
(tile-local output columns 4j and 4j+3, a quarter of each of their taps).
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


def _check(r, height, width):
    assert r["shape"] == r["want_shape"] == (4 * height, 4 * width, 3)
    assert r["dtype"] == "torch.uint8" and r["device"] == "cuda"
    assert r["launches"] == 1
    assert r["max_diff"] <= 1 and r["frac_diff"] < 1e-3, r
    assert r["std_min"] > 5                    # not a flat frame


@pytest.mark.parametrize("bgr", [False, True], ids=["rgb", "bgr"])
@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_kernel_matches_twin(port, geom, mode, bgr):
    ny, nx, cr, height, width = geom
    _check(port("cuda_kernel_vs_twin", ny, nx, cr, height, width, mode, bgr),
           height, width)


@pytest.mark.parametrize("bgr", [False, True], ids=["rgb", "bgr"])
@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_srgan_kernel_matches_twin(port, geom, mode, bgr):
    ny, nx, cr, height, width = geom
    _check(port("cuda_kernel_vs_twin", ny, nx, cr, height, width, mode, bgr,
                family="srgan"), height, width)


@pytest.mark.parametrize("family", ["fsrgan", "srgan"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_w8a8_kernel_is_bit_identical(port, geom, family):
    ny, nx, cr, height, width = geom
    r = port("cuda_kernel_vs_twin", ny, nx, cr, height, width, "w8a8", False,
             family=family)
    _check(r, height, width)
    assert r["max_diff"] == 0, r


# (n, h, w): band and chunk dividing nothing; the 1080p tile; one partial block
MBCONV_SHAPES = [(2, 13, 37), (1, 139, 124), (3, 5, 7)]


@pytest.mark.parametrize("expand", [True, False], ids=["expand", "no_expand"])
@pytest.mark.parametrize("shape", MBCONV_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mbconv_kernel_matches_reference(port, shape, expand):
    r = port("cuda_mbconv_vs_reference", *shape, expand)
    assert r["shape"] == (*shape, 32)
    assert r["dtype"] == "torch.bfloat16" and r["device"] == "cuda"
    assert r["launches"] == 1
    assert r["max_diff"] == 0, r


@pytest.mark.parametrize("bad", ["dtype", "layout"])
def test_mbconv_wrapper_refuses_on_card(port, bad):
    with pytest.raises(ValueError):
        port("cuda_mbconv_bad_input", bad)


def test_build_generator_defaults_to_card(port):
    assert port("default_generator_device") == "cuda"
