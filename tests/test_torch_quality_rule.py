"""The whole-frame quality rule (tools/exp_q8_exact.py) for the port's
engines, against the exact whole-frame output on a seeded u8-representable
noise frame (the int8 modes calibrated on it).

On the JAX package's own initialisation (the generators' ``init`` at key 0,
as tools/exp_q8_exact.py scores them, and chip_smoke.py's numpy draw of the
same initialisers), the rule itself holds: w8a8's share
of bytes > 1 level from the exact output is at most bf16's + 0.1 percentage
point, qh8's at most w8a8's + 0.1 pp, and the int8 modes' max at most
bf16's + 2; and the qh8 engine is within the JAX package's qh8 envelope of
the w8a8 engine (max <= 2, > 1 on < 5e-3; test_pallas_tail.py:185-186).

On the seeded generators that chip_smoke.py drives on the card the rule
does not hold, for the JAX package as for the port, so there the test is
ROADMAP.md's form of it: the port's engines are no farther from the exact
output than the JAX package's engines on the same weights and frame.  The
weights of that test are chip_smoke.py's;
the exact output is chip_smoke.py's (the port's plain bf16 generator on the
whole frame, edge-padded to 8 rows and 128 columns); the JAX engines run
their Pallas tails in interpret mode.  The port runs in a child process
(tests/torch_process.py).

Measured at 135x240 (brc 27, a seeded u8-representable noise frame),
share of bytes > 1 level from the exact output, port vs JAX: FSRGAN bf16
24.305% vs 24.305%, w8a8 40.754% vs 40.745%, qh8 43.174% vs 43.197%;
SRGAN bf16 6.160% vs 6.160%, w8a8 18.094% vs 18.082%, qh8 22.488% vs
22.500%; max 105-107 and 97-98 in both.  So tools/exp_q8_exact.py's own
rule (w8a8 within 0.1 pp of bf16, qh8 within 0.1 pp of w8a8) fails on these
weights for the JAX package as for the port: it measures the weights and
the int8 modes, not the port.  Bound: the port's share > 1 at most JAX's +
0.1 pp, and its max at most JAX's + 2 (the rule's own margins).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.infer import kernel_engine as jke  # noqa: E402
from denoise_gan_tpu.models.fsrgan import FSRGANGenerator as JGen  # noqa: E402
from denoise_gan_tpu.models.srgan import SRGANGenerator as JGen64  # noqa: E402

H, W, BRC = 135, 240, 27


@pytest.fixture(scope="module")
def port():
    with torch_process() as call:
        yield call


def _noise_frame():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
            .astype(np.float32) / np.float32(255))


@pytest.mark.parametrize("source", ["flax", "chip_smoke"])
@pytest.mark.parametrize("family", ["fsrgan", "srgan"])
def test_rule_holds_on_jax_init(port, family, source):
    """source "flax": the generator's Flax init at key 0; "chip_smoke": the
    same initialisers drawn with numpy, as chip_smoke.py's phase 4d draws
    them on the card."""
    if source == "flax":
        cls = JGen if family == "fsrgan" else JGen64
        v = cls().init(jax.random.key(0), jnp.zeros((1, 124, 124, 3)),
                       train=False)
        params = jax.tree_util.tree_map(np.asarray, v["params"])
        stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    else:
        params, stats = port("chip_smoke_jax_init_trees", family)
    exact, outs = port("whole_frame_and_engines", params, stats,
                       _noise_frame(), BRC, family=family)
    d = {m: np.abs(outs[m].astype(np.int32) - exact) for m in outs}
    for m in d:
        print(f"{family} {m} vs exact: max {d[m].max()}, > 1 on "
              f"{(d[m] > 1).mean():.5f}")
    over = {m: (d[m] > 1).mean() for m in d}
    assert over["w8a8"] <= over["bf16"] + 1e-3, over
    assert over["qh8"] <= over["w8a8"] + 1e-3, over
    assert max(d["w8a8"].max(), d["qh8"].max()) <= d["bf16"].max() + 2
    q = np.abs(outs["qh8"].astype(np.int32) - outs["w8a8"])
    print(f"{family} qh8 vs w8a8 engine: max {q.max()}, > 1 on "
          f"{(q > 1).mean():.2e}")
    assert q.max() <= 2 and (q > 1).mean() < 5e-3


@pytest.mark.parametrize("family", ["fsrgan", "srgan"])
def test_engines_no_farther_from_whole_frame_than_jax(port, family):
    params, stats = port("chip_smoke_trees", family)
    frame = _noise_frame()
    exact, outs = port("whole_frame_and_engines", params, stats, frame, BRC,
                       family=family)
    assert exact.shape == (H * 4, W * 4, 3) and exact.dtype == np.uint8
    build = (jke.build_fsrgan_kernel_engine if family == "fsrgan"
             else jke.build_srgan_kernel_engine)
    calib = {"q8_calib_frame": jnp.asarray(frame)}
    for mode, kw in (("bf16", {}), ("w8a8", calib),
                     ("qh8", dict(calib, qh8=True))):
        jeng = build(params, stats, H, W, brc=BRC, interpret=True, **kw)
        want = np.asarray(jke.flat_view(jeng(jnp.asarray(frame)), H, W))
        d_jax = np.abs(want.reshape(H * 4, W * 4, 3).astype(np.int32)
                       - exact)
        d_port = np.abs(outs[mode].astype(np.int32) - exact)
        print(f"{family} {mode} vs exact: port max {d_port.max()} > 1 on "
              f"{(d_port > 1).mean():.5f}, JAX max {d_jax.max()} > 1 on "
              f"{(d_jax > 1).mean():.5f}")
        assert (d_port > 1).mean() <= (d_jax > 1).mean() + 1e-3, mode
        assert d_port.max() <= d_jax.max() + 2, mode
