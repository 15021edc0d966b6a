"""The kernel engines' ``plan`` override (denoise_gan_tpu_torch/infer/
kernel_engine.py): the FSRGAN and SRGAN engines built with a grid other
than plan_grid's equal the JAX engines given the same ``plan``
(denoise_gan_tpu/infer/kernel_engine.py:75, 89-91), within the engines'
envelopes (tests/test_torch_engine.py, test_torch_engine_srgan.py: the
bf16 bodies round apart in XLA and PyTorch): FSRGAN bf16 max 1 level on
< 1e-3 of the bytes, SRGAN bf16 max 1 on < 5%.  Two
plans give different seams, so the override is seen; one that does not
cover the frame raises.  The port runs in a child process
(tests/torch_process.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_process import TIMEOUT_S, skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.infer import kernel_engine as jke  # noqa: E402
from denoise_gan_tpu.models.fsrgan import FSRGANGenerator  # noqa: E402
from denoise_gan_tpu.models.srgan import SRGANGenerator  # noqa: E402
from training_oracles import draw  # noqa: E402

H, W, BRC = 64, 70, 8
PLANS = ((2, 1, 32), (1, 1, 64))       # plan_grid gives (8, 1, 8)
BUILD = {"fsrgan": (FSRGANGenerator, jke.build_fsrgan_kernel_engine),
         "srgan": (SRGANGenerator, jke.build_srgan_kernel_engine)}


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_parallel") as call:
        yield call


def _scaled(tree, gain, path=()):
    """SRGAN's residual-block and post-conv kernels times `gain`, as
    tests/test_torch_engine_srgan.py seeds them (16 blocks of drawn
    kernels at full scale amplify the bodies' rounding apart)."""
    return {k: _scaled(v, gain, path + (k,)) if hasattr(v, "items") else
            v * gain if k == "kernel" and "body" in path and
            path[-1] != "Conv_0" else v for k, v in tree.items()}


def _weights(family, seed):
    v = jax.eval_shape(lambda: BUILD[family][0]().init(
        jax.random.key(0), jnp.zeros((1, 16, 16, 3)), train=False))
    rng = np.random.default_rng(seed)
    params = draw(v["params"], rng)
    if family == "srgan":
        params = _scaled(params, np.float32(0.1))
    return params, draw(v["batch_stats"], rng)


@pytest.fixture(scope="module")
def frame():
    return np.random.default_rng(2).random((H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    return {"fsrgan": _weights("fsrgan", 3), "srgan": _weights("srgan", 4)}


@pytest.fixture(scope="module")
def started(port, weights, frame):
    """The port's engines, started in the child before the JAX engines run
    here: their futures (the first frame each)."""
    def engine(family, plan):
        return port.submit("engine_with_plan", family, *weights[family], H,
                           W, BRC, plan, [frame])
    return {"fsrgan": engine("fsrgan", PLANS[0]),
            "fsrgan_other": engine("fsrgan", PLANS[1]),
            "srgan": engine("srgan", PLANS[0]),
            "refused": port.submit("plan_refused", *weights["fsrgan"])}


def _diff(started, family, weights, frame, plan):
    eng = BUILD[family][1](*weights, H, W, brc=BRC, interpret=True,
                           plan=plan)
    want = np.asarray(jke.flat_view(eng(jnp.asarray(frame)), H, W))
    got = started[family].result(TIMEOUT_S)[0]
    return got, np.abs(got.astype(np.int32)
                       - want.reshape(H * 4, W * 4, 3).astype(np.int32))


def test_plan_grid_is_not_the_plans():
    assert jke.plan_grid(H, W, BRC) not in PLANS


def test_fsrgan_plans_match_jax(started, weights, frame):
    got, d = _diff(started, "fsrgan", weights["fsrgan"], frame, PLANS[0])
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())
    other = started["fsrgan_other"].result(TIMEOUT_S)[0]
    assert not np.array_equal(got, other)      # other seams


def test_srgan_plan_matches_jax(started, weights, frame):
    _, d = _diff(started, "srgan", weights["srgan"], frame, PLANS[0])
    assert d.max() <= 1 and (d > 0).mean() < 5e-2, (d.max(), (d > 0).mean())


def test_plan_must_cover_frame(started):
    msg = started["refused"].result(TIMEOUT_S)
    assert msg is not None and "does not cover" in msg
