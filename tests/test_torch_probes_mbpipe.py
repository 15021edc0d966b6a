"""The port's K5 probe (denoise_gan_tpu_torch/probes/mbpipe.py) vs the JAX
probe's own Pallas kernel (tools/exp_mbpipe.py::_kernel), run in interpret
mode, from the same state.  The port runs in a child process
(tests/torch_process.py).

The JAX kernel runs inside a wrapping pallas_call that also returns its
scratch after 0 to 3 steps of one and of two chains: r1, r2, E and D of
both slots, and p recomputed from each slot's D by the kernel's own dot
(the probe's output o reads columns that no step writes, and chain 2 is a
fixed point: its o is the same for every run, so the tests compare the
whole buffers).  Bounds:

* one step (the port's step from the JAX kernel's bands after reps - 1
  steps, against its step reps): E within 4 * 2**-22 * max |E| (f32 sums
  of 32 exact products in two orders, then one rounding of the bias add;
  measured 0: these sums are exact); D within 9 * 2**-22 * max |D| (K4's
  bound: the taps may round twice in XLA where the port rounds once;
  measured 0.04 of it); p within 192 * 2**-24 * (|wp|^T |D|), the f32
  sum-order bound of its 192 terms, plus (|wp|^T 1) * max |dD| for the two
  sides' D (measured 0.055 of it); the new r1 within one bf16 ulp of the
  JAX one wherever it differs (sums of p in two orders can round the
  update apart), on at most 1e-3 of its window (measured 0), r2 exact, and
  the columns outside 128..2047 exact;
* whole chains from the initial state, reps 1-3: r1 the same way (the
  steps' differences do not compound: measured 0 values apart), r2
  exact, and one chain's r1 equal to the two chains' r1 on both sides.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from torch_process import skip_without_torch, torch_process

skip_without_torch()


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(__file__), "..", "tools",
                           f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jmb = _load("exp_mbpipe")

MB, MP = jmb.MB, jmb.MP
STEPS = [1, 2, 3]
RUNS = ((0, 1),) + tuple((t, c) for c in (1, 2) for t in STEPS)
WINDOW_SHARE = 1e-3          # share of r1's window allowed one ulp apart


@pytest.fixture(scope="module")
def port():
    with torch_process() as call:
        yield call


@functools.lru_cache(maxsize=None)
def _pallas_k5():
    """The probe's kernel in interpret mode once per (reps, chains) of
    RUNS, each from its own initial state: per run a dict of r1, r2 (as
    f32), e (2, 192, MB), d (2, 192, MP), p (2, 32, MP) and the output o;
    the weights of the first run under "we", "wp", "wdw"."""
    names = ("r1", "r2", "e", "d", "p", "o")
    shapes = ((32, MB), (32, MB), (2, 192, MB), (2, 192, MP), (2, 32, MP),
              (8, 128))

    def wrapped(*refs):
        n = len(names) * len(RUNS)
        outs, (we_o, wp_o, wdw_o) = refs[:n], refs[n:n + 3]
        r1, r2, e_buf, el, er, d_buf, we, wp, wdw = refs[n + 3:]
        for i, (reps, chains) in enumerate(RUNS):
            r1o, r2o, eo, do, po, o_ref = outs[len(names) * i:
                                               len(names) * (i + 1)]
            jmb._kernel(o_ref, r1, r2, e_buf, el, er, d_buf, we, wp, wdw,
                        reps=reps, chains=chains)
            r1o[:] = r1[:].astype(jnp.float32)
            r2o[:] = r2[:].astype(jnp.float32)
            eo[:] = e_buf[:]
            do[:] = d_buf[:]
            for s in range(2):      # the kernel's project, :69-71
                po[s] = jax.lax.dot_general(
                    wp[:], d_buf[s], (((0,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32)
        we_o[:] = we[:].astype(jnp.float32)
        wp_o[:] = wp[:].astype(jnp.float32)
        wdw_o[:] = wdw[:, :, 0]

    out_shapes = [jax.ShapeDtypeStruct(s, jnp.float32)
                  for _ in RUNS for s in shapes]
    out_shapes += [jax.ShapeDtypeStruct(s, jnp.float32)
                   for s in ((32, 192), (192, 32), (9, 192))]
    out = pl.pallas_call(
        wrapped, out_shape=tuple(out_shapes),
        scratch_shapes=[
            pltpu.VMEM((32, MB), jnp.bfloat16),
            pltpu.VMEM((32, MB), jnp.bfloat16),
            pltpu.VMEM((2, 192, MB), jnp.float32),
            pltpu.VMEM((2, 192, MB), jnp.float32),
            pltpu.VMEM((2, 192, MB), jnp.float32),
            pltpu.VMEM((2, 192, MP), jnp.float32),
            pltpu.VMEM((32, 192), jnp.bfloat16),
            pltpu.VMEM((192, 32), jnp.bfloat16),
            pltpu.VMEM((9, 192, 1), jnp.float32)],
        interpret=True)()
    out = [np.asarray(a) for a in out]
    runs = {run: dict(zip(names, out[len(names) * i:len(names) * (i + 1)]))
            for i, run in enumerate(RUNS)}
    runs["we"], runs["wp"], runs["wdw"] = out[-3:]
    return runs


def _state(run):
    k5 = _pallas_k5()
    return (k5[run]["r1"], k5[run]["r2"], k5["we"], k5["wp"], k5["wdw"])


def _bf16_ulp(a):
    """One bf16 ulp of each value of a (float64; the smallest normal's at
    0)."""
    a = np.maximum(np.abs(a.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _check_r1(got, want):
    """r1 within one bf16 ulp of want where it differs, on at most
    WINDOW_SHARE of the window, and exact outside the window; returns the
    share that differs."""
    np.testing.assert_array_equal(got[:, :128], want[:, :128])
    np.testing.assert_array_equal(got[:, 128 + MP:], want[:, 128 + MP:])
    win, wwin = got[:, 128:128 + MP], want[:, 128:128 + MP]
    d = np.abs(win.astype(np.float64) - wwin)
    share = float((d > 0).mean())
    assert (d <= _bf16_ulp(wwin)).all() and share <= WINDOW_SHARE, share
    return share


def test_initial_state_matches_pallas(port):
    got = port("probe_mbpipe_initial_state")
    for a, b in zip(got, _state((0, 1))):
        np.testing.assert_array_equal(a, b)


def test_output_cannot_see_the_steps():
    """The JAX probe's o is the same after every run: it reads r's columns
    0..127, which no step writes, while every step moves all of r1's
    window and none of r2."""
    k5 = _pallas_k5()
    r1_0, r2_0 = k5[0, 1]["r1"], k5[0, 1]["r2"]
    for run in RUNS[1:]:
        np.testing.assert_array_equal(k5[run]["o"], k5[0, 1]["o"])
        np.testing.assert_array_equal(k5[run]["r2"], r2_0)
        assert (k5[run]["r1"][:, 128:128 + MP]
                != r1_0[:, 128:128 + MP]).all()


@pytest.mark.parametrize("reps", STEPS)
@pytest.mark.parametrize("chains", [1, 2])
def test_step_matches_pallas(port, chains, reps):
    k5 = _pallas_k5()
    before, want = (reps - 1, chains if reps > 1 else 1), k5[reps, chains]
    r1, r2, e, d, p = port("probe_mbpipe_chain", *_state(before), 1, chains)
    assert e.shape == (chains, 192, MB) and d.shape == (chains, 192, MP) \
        and p.shape == (chains, 32, MP)
    wp_abs = np.abs(k5["wp"].astype(np.float64))
    for q in range(chains):
        we_, wd_, wp_ = want["e"][q], want["d"][q], want["p"][q]
        de = float(np.abs(e[q] - we_).max())
        dd = float(np.abs(d[q] - wd_).max())
        e_bound = 4 * 2.0 ** -22 * float(np.abs(we_).max())
        d_bound = 9 * 2.0 ** -22 * float(np.abs(wd_).max())
        p_bound = 192 * 2.0 ** -24 * (wp_abs.T @ np.abs(wd_.astype(
            np.float64))) + wp_abs.sum(0)[:, None] * dd
        dp = np.abs(p[q].astype(np.float64) - wp_)
        print(f"chain {q + 1}: max |dE| {de:.3e} = {de / e_bound:.3f} of "
              f"the bound, |dD| {dd:.3e} = {dd / d_bound:.3f}, |dp| "
              f"{dp.max():.3e} = {float((dp / p_bound).max()):.3f}")
        assert np.isfinite(wd_).all() and de <= e_bound and dd <= d_bound
        assert (dp <= p_bound).all()
    share = _check_r1(r1, want["r1"])
    print(f"r1 window one ulp apart on {share:.2e}")
    np.testing.assert_array_equal(r2, want["r2"])


@pytest.mark.parametrize("reps", STEPS)
def test_chains_match_pallas(port, reps):
    """From the initial state, the port's whole chains against the JAX
    kernel's: r1 as one step's, r2 exact, and one chain's r1 equal to two
    chains' r1 on both sides (the chains are independent)."""
    k5 = _pallas_k5()
    init = _state((0, 1))
    one = port("probe_mbpipe_chain", *init, reps, 1)
    two = port("probe_mbpipe_chain", *init, reps, 2)
    np.testing.assert_array_equal(one[0], two[0])
    np.testing.assert_array_equal(k5[reps, 1]["r1"], k5[reps, 2]["r1"])
    share = _check_r1(two[0], k5[reps, 2]["r1"])
    print(f"r1 window one ulp apart on {share:.2e} after {reps} steps")
    for got in (one[1], two[1]):
        np.testing.assert_array_equal(got, k5[reps, 2]["r2"])
    np.testing.assert_array_equal(two[1], init[1])


def test_seeded_bands_are_independent_chains(port):
    """On a seeded state of three bands the plain version's band axis is
    three separate chains, and both chains move (no fixed point)."""
    for chains in (1, 2):
        same, moved = port("probe_mbpipe_seeded_bands", chains)
        assert same, chains
        assert moved[0] > 0.01 and (moved[1] > 0.01) == (chains == 2), moved


def test_wrapper_runs_plain_version_on_cpu(port):
    equal, launched = port("probe_mbpipe_wrapper_on_cpu")
    assert all(equal.values()), equal
    assert not any(launched.values()), launched


def test_entry_points_raise_without_gpu(port):
    raised = port("probe_mbpipe_entry_points_without_gpu")
    assert set(raised.values()) == {"RuntimeError"}, raised


@pytest.mark.parametrize("bad", ["dtype", "r_shape", "w_shape", "wdw_dtype",
                                 "chains", "reps", "sync", "bands"])
def test_refuses_bad_input(port, bad):
    with pytest.raises(ValueError):
        port("probe_mbpipe_bad_input", bad)
