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
up1 sums in the twin's order, and in qh8 mode up1's sums are integers too,
so kernel and twin agree byte for byte; for FSRGAN that includes the
output-conv taps that read R quantised from bf16 (tile-local output columns
4j and 4j+3, a quarter of each of their taps).  The canvas epilogue (the
bf16 tanh that the u8 epilogue rounds) is held to the same: equal in the
int8 modes, and in bf16 apart by at most 2**-8 (one bf16 ulp at the top of
tanh's range: one rounding apart) on < 2e-3 of the values, about twice
the largest reading on the H100 (bf16 values round apart more often than
bytes: 1.03e-3 at 1x2x24, where the bytes differ on < 1e-3; 1.11e-3 for
K1 at 1080p in chip_smoke.py).
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


def _check(r, height, width, canvas=False):
    print(f"max {r['max_diff']:.3e}, differing {r['frac_diff']:.3e}")
    assert r["shape"] == r["want_shape"] == (4 * height, 4 * width, 3)
    assert r["dtype"] == ("torch.bfloat16" if canvas else "torch.uint8")
    assert r["device"] == "cuda" and r["launches"] == 1
    assert r["max_diff"] <= (2.0 ** -8 if canvas else 1), r
    assert r["frac_diff"] < (2e-3 if canvas else 1e-3), r
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


@pytest.mark.parametrize("bgr", [False, True], ids=["rgb", "bgr"])
@pytest.mark.parametrize("family", ["fsrgan", "srgan"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_qh8_kernel_is_bit_identical(port, geom, family, bgr):
    """qh8: int8 h from quantize_h, up1 on __dp4a."""
    ny, nx, cr, height, width = geom
    r = port("cuda_kernel_vs_twin", ny, nx, cr, height, width, "qh8", bgr,
             family=family)
    _check(r, height, width)
    assert r["max_diff"] == 0, r


@pytest.mark.parametrize("mode", ["bf16", "w8a8", "qh8"])
@pytest.mark.parametrize("family", ["fsrgan", "srgan"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_canvas_kernel_matches_twin(port, geom, family, mode):
    ny, nx, cr, height, width = geom
    r = port("cuda_kernel_vs_twin", ny, nx, cr, height, width, mode, False,
             family=family, canvas=True)
    _check(r, height, width, canvas=True)
    if mode != "bf16":
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


# The probes (denoise_gan_tpu_torch/probes/) at sizes that chip_smoke.py's
# JAX shapes do not reach: a few rows, element and column counts that are
# not a multiple of a block or of K6's 32-column slab, one column, and K6
# in bf16 at K = 1152, where w streams from L2 every step.  K9: bit-identical
# (fmaf and the plain version's fma_f32 each round a multiply-add once).  K6: int8
# bit-identical after `iters` chained steps; bf16 each step, from the
# kernel's previous state, within int8_chain.bf16_step_bound (one bf16
# rounding after f32 sums in another order), and one launch of those steps
# equal to the steps; rows >= 128 unchanged.  From the probe's initial
# state (where int8 saturates at 127 within two steps) and from a random
# one (both signs, rarely saturated).

@pytest.mark.parametrize("iters", [0, 37, 256])
@pytest.mark.parametrize("shape", [(3, 1000), (1, 7), (5, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_probe_fma_kernel_matches_plain(port, shape, iters):
    r = port("cuda_probe_fma", shape, iters)
    print(r)
    assert r["shape"] == shape and r["launches"] == 1
    assert r["equal"], r


@pytest.mark.parametrize("iters", [1, 128])
@pytest.mark.parametrize("rows,width", [(1, 1024), (3, 1024), (5, 1024),
                                        (6, 1024)])
def test_probe_roll_kernel_matches_plain(port, rows, width, iters):
    r = port("cuda_probe_roll", rows, width, iters)
    print(r)
    assert r["shape"] == (rows, width) and r["launches"] == 1
    assert r["equal"], r


@pytest.mark.parametrize("width", [1000, 128, 256, 512, 2048])
def test_probe_roll_kernel_refuses_width(port, width):
    with pytest.raises(ValueError):
        port("cuda_probe_roll_bad_width", width)


@pytest.mark.parametrize("state", ["probe", "random"])
@pytest.mark.parametrize("m", [1, 37, 100])
@pytest.mark.parametrize("k", [128, 384, 1152])
@pytest.mark.parametrize("dtype,iters", [("int8", 50), ("bf16", 4)])
def test_probe_dot_chain_matches_plain(port, dtype, iters, k, m, state):
    r = port("cuda_probe_dot_chain", k, m, iters, dtype, state)
    print(r)
    assert r["shape"] == (k, m) and r["rest_kept"]
    assert r["launches"] == (1 if dtype == "int8" else iters + 1)
    if dtype == "int8":
        assert r["equal"], r
    else:
        assert r["bound_ratio"] <= 1 and r["one_launch"], r


@pytest.mark.parametrize("bad", ["dtype", "w_shape", "short_k", "chunk"])
def test_probe_dot_chain_refuses_on_card(port, bad):
    with pytest.raises(ValueError):
        port("probe_dot_chain_bad_input", bad, device="cuda")


def test_probe_dot_chain_too_deep_fails_at_launch(port):
    # bf16 K = 2560: the slab and the ring of w chunks exceed a block's
    # shared memory, and the C entry point refuses the launch
    with pytest.raises(RuntimeError):
        port("probe_dot_chain_bad_input", "deep", device="cuda")


# K8 and K10 (probes/relayout.py, probes/u8_store.py) at the JAX probes'
# shapes and at sizes they do not reach: an M that is not a multiple of 16
# (ragged rows of A or columns of B, by form), a few reps that do not
# divide among the split CTAs, transposes of ragged tiles, and the u8
# store at one band.  K8's product: every element within
# relayout.product_bound (f32 sums in another order than the ideal
# accumulator), acc within relayout.acc_bound; the transpose chain and the
# u8 store bit-identical (one f32 multiply each step; tanhf and the plain
# version's steps rounded apart).

@pytest.mark.parametrize("reps", [1, 7, 64])
@pytest.mark.parametrize("shape", [(2048, 384, 128), (2048, 1152, 128),
                                   (1024, 1152, 48), (37, 384, 48),
                                   (100, 1152, 72)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("form", ["canonical", "sublane"])
def test_probe_matmul_form_matches_plain(port, form, shape, reps):
    r = port("cuda_probe_matmul_form", *shape, form, reps)
    print(r)
    m, _, n = shape
    assert r["shape"] == ((m, n) if form == "canonical" else (n, m))
    assert r["launches"] == 1
    assert r["y_ratio"] <= 1 and r["acc_ratio"] <= 1, r


@pytest.mark.parametrize("iters", [0, 8, 33])
@pytest.mark.parametrize("rows,cols", [(1536, 128), (45, 70), (1, 33)])
def test_probe_transpose_chain_matches_plain(port, rows, cols, iters):
    r = port("cuda_probe_transpose_chain", rows, cols, iters)
    print(r)
    assert r["shape"] == (rows, cols) and r["launches"] == 1
    assert r["equal"], r


@pytest.mark.parametrize("m", [128, 1024])
def test_probe_u8_store_matches_plain(port, m):
    r = port("cuda_probe_u8_store", m)
    print(r)
    assert r["shape"] == (m // 128, 4, 128, 12) and r["launches"] == 1
    assert r["dtype"] == "torch.uint8" and r["equal"], r


@pytest.mark.parametrize("bad", ["dtype", "form", "x_shape", "reps",
                                 "u8_cols", "u8_rows", "u8_dtype"])
def test_probe_relayout_and_u8_refuse_on_card(port, bad):
    with pytest.raises(ValueError):
        port("probe_relayout_bad_input", bad, device="cuda")


@pytest.mark.parametrize("bad", ["k_step", "k_max"])
def test_probe_matmul_form_launch_refuses_k(port, bad):
    """K not a multiple of 64, or above the 1152 whose operands fit in a
    block's shared memory: the entry point refuses the launch."""
    with pytest.raises(RuntimeError):
        port("probe_relayout_bad_input", bad, device="cuda")


# K7 and K4 (probes/overlap.py, probes/dw_forms.py).  K7: z bit-identical
# to the plain version at the JAX counts in every mode (fmaf(z, c1,
# roll * c2) on both sides), y's columns 128.. kept; y step by step for 8
# steps from the kernel's previous state, each within overlap.step_bound
# (one bf16 rounding after f32 sums in another order), and one launch of
# the 8 steps equal to them.  K4: every form bit-identical to its plain
# version (fmaf in the JAX order on both sides) at 1, 37 and 2000 reps and
# at 1, 7 and 192 channels.

@pytest.mark.parametrize("counts", [(4000, 0), (0, 3000), (4000, 3000),
                                    (1, 2)])
def test_probe_overlap_z_matches_plain(port, counts):
    r = port("cuda_probe_overlap_full", *counts)
    print(r)
    assert r["launches"] == 1 and r["z_equal"] and r["kept"], r


@pytest.mark.parametrize("counts", [(1, 0), (1, 1)])
def test_probe_overlap_y_steps_within_bound(port, counts):
    r = port("cuda_probe_overlap_steps", *counts, 8)
    print(r)
    assert r["finite"] and r["equal"] and r["one_launch"], r
    assert r["ratio"] <= 1, r


@pytest.mark.parametrize("bad", ["dtype", "z_shape", "w_shape", "iters",
                                 "width", "contiguous", "device"])
def test_probe_overlap_refuses_on_card(port, bad):
    with pytest.raises(ValueError):
        port("probe_overlap_bad_input", bad, device="cuda")


@pytest.mark.parametrize("nch", [1, 7, 192])
@pytest.mark.parametrize("reps", [1, 37, 2000])
@pytest.mark.parametrize("form", ["scratch", "value", "chunked", "planes"])
def test_probe_dw_matches_plain(port, form, reps, nch):
    r = port("cuda_probe_dw", nch, reps, form)
    print(r)
    assert r["launches"] == 1 and r["equal"], r
    assert r["shapes"] == ((nch, 2176), (nch, 1920))


@pytest.mark.parametrize("bad", ["dtype", "form", "width", "w_shape",
                                 "reps", "contiguous", "device"])
def test_probe_dw_refuses_on_card(port, bad):
    with pytest.raises(ValueError):
        port("probe_dw_bad_input", bad, device="cuda")
