"""The margins of the fused inverted residual's kernel (K3, csrc/mbconv.cu)
in plain PyTorch (ops/mbconv.py: d_margin, y_margin, certain, margin_parts)
and the one-sign inputs (one_sign_x, one_sign_block).

The kernel sums the expand and the project on the tensor cores, in an
order other than the plain version's, keeps such a result only where its
bf16 rounding (d after ReLU, y) is certain within the margin, and sums the
rest again in the plain order.  Here the kernel's route runs in plain
PyTorch with its tensor-core sums taken in other orders: exact in float64
and rounded once, one product at a time from the last, and the exact sum
moved by 0.9 of the tensor core's allowance (the sign drawn per sum).  On
a seeded block and on the one-sign input (every product of the two sums
>= 0, the biases cancelling the large sums), with and without the expand:
the other orders stay within the allowance that the margins assume; d
and y equal the plain version's wherever the test says certain; taking
the plain order for the others gives fused_mbconv_reference bit for bit;
the tests leave at most a fifth of the values uncertain; and at the
allowance's edge the other order's roundings do move apart, all of them
within the uncertain values.  The port runs in a child process
(tests/torch_process.py); no JAX function has these margins.
"""

import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()


@pytest.fixture(scope="module")
def port():
    with torch_process() as call:
        yield call


@pytest.mark.parametrize("order", ["f64", "reversed", "allowance"])
@pytest.mark.parametrize("one_sign", [False, True], ids=["seeded", "one_sign"])
@pytest.mark.parametrize("expand", [True, False], ids=["expand", "no_expand"])
def test_margin_keeps_plain_rounding(port, expand, one_sign, order):
    r = port("mbconv_margin_case", 3, expand, one_sign, order)
    print(r)
    assert r["plain_is_reference"]
    assert r.get("premise_e", 0) == 0 and r["premise_p"] == 0
    assert r["d_wrong"] == 0 and r["y_wrong"] == 0
    assert r["routed_is_reference"]
    assert r["d_uncertain"] <= 0.2 * r["d_values"]
    assert r["y_uncertain"] <= 0.2 * r["y_values"]
    if order == "allowance":
        assert r["y_apart"] > 0 and (r["d_apart"] > 0) == expand
    if not expand:
        assert r["d_uncertain"] == 0       # e = x: the depthwise is exact


def test_one_sign_inputs(port):
    """Every expand, depthwise and project weight and every x >= 0, bf16
    biases, and the expand's and the project's sums cancelled by their
    biases to within a hundredth of their size."""
    r = port("mbconv_one_sign", 4)
    print(r)
    assert r["nonneg"] and r["dtype"] == "torch.bfloat16"
    assert abs(r["s_mean"]) < 0.01 * r["s_size"]
    assert abs(r["p_mean"]) < 0.01 * r["p_size"]


def test_margin_parts_are_the_kernels_f32(port):
    """The margin parts that the kernel reports as f32 (dgt_mbconv_params,
    held equal to these on the card): each is an f32 value, the plain
    order's part at the expand is gamma_31, and the tensor core's parts
    are at most 2**-17."""
    parts = port("mbconv_margin_parts")
    assert len(parts) == 7
    assert all(np.float32(v) == v and v > 0 for v in parts)
    assert parts[0] == pytest.approx(31 * 2.0 ** -24, rel=1e-5)
    assert max(parts[1], parts[2]) <= 2.0 ** -17
