"""The port's K7 and K4 probes (denoise_gan_tpu_torch/probes/overlap.py,
dw_forms.py) vs the JAX probes' own Pallas kernels, run in interpret mode,
from the same state.  The port runs in a child process
(tests/torch_process.py).

K7, tools/exp_overlap_probe.py: ``_kernel`` in a pallas_call that also
returns the whole y and z scratch after 0 to 3 iterations of each mode, a
(t, 0), b (0, t) and c (t, t), against ``overlap_chain`` from the JAX
kernel's own initial state.  y's columns 128.. must be equal; its columns
0..127 within t bf16 ulps of their max |JAX| at step t (each step's sums
round to bf16 from f32 in XLA and from float64 in the port, one rounding
apart at most, and later steps carry that on); z within t * 2**-22 *
max |JAX| (per step the two may round up to two f32 ulps of the largest
value apart: the port rounds the roll's product once and then fuses the
multiply-add, as the CUDA kernel does; XLA's CPU backend contracts the
same way in most of its programs and not in all: measured 0 and 1 ulp).
The probe's output o within the sum of the two bounds.  Mode c at (3, 2)
runs both chains 3 times, on both sides: the probe's truthiness tests.

K4, tools/exp_dw_forms.py: ``_kernel`` of each form in a pallas_call that
also returns e and d after 0 to 3 reps, against ``dw_chain`` from the JAX
kernel's own e and weights.  Bound: |d| within reps * 9 * 2**-22 *
max |JAX d| (each of the 9 multiply-adds may round twice in XLA where the
port rounds once: measured at most 0.15 of it), e's columns 128.. equal
and its chunk 0 within 1e-3 of that plus one f32 ulp.  The port's
``chunked`` differs from its ``scratch`` exactly at columns 0 and 127 of
each output chunk, and its scratch, value and planes are one function.
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


jov = _load("exp_overlap_probe")
jdw = _load("exp_dw_forms")

M = jov.M
STEPS = [0, 1, 2, 3]
K7_MODES = {"a": lambda t: (t, 0), "b": lambda t: (0, t),
            "c": lambda t: (t, t)}
FORMS = list(jdw.FORMS)
NCH, MB, MP = jdw.NCH, jdw.MB, jdw.MP


@pytest.fixture(scope="module")
def port():
    with torch_process() as call:
        yield call


@functools.lru_cache(maxsize=None)
def _pallas_k7(runs):
    """The probe's kernel in interpret mode once per (mxu_iters, vpu_iters)
    of `runs`, each from its own initial state: per run (o, y as f32, z)."""
    def wrapped(*refs):
        outs, (y, z) = refs[:-2], refs[-2:]
        for i, (mi, vi) in enumerate(runs):
            o_ref, y_out, z_out = outs[3 * i:3 * i + 3]
            jov._kernel(o_ref, y, z, mi, vi)
            y_out[:] = y[:].astype(jnp.float32)
            z_out[:] = z[:]

    shapes = [jax.ShapeDtypeStruct(s, jnp.float32)
              for _ in runs for s in ((8, 128), (128, M), (8, M))]
    out = pl.pallas_call(
        wrapped, out_shape=tuple(shapes),
        scratch_shapes=[pltpu.VMEM((128, M), jnp.bfloat16),
                        pltpu.VMEM((8, M), jnp.float32)],
        interpret=True)()
    out = [np.asarray(a) for a in out]
    return [tuple(out[3 * i:3 * i + 3]) for i in range(len(runs))]


def _k7_mode(mode):
    return _pallas_k7(tuple(K7_MODES[mode](t) for t in STEPS))


def _bf16_ulp(a):
    return 2.0 ** (np.floor(np.log2(float(np.abs(a).max()))) - 7)


def test_overlap_initial_state_matches_pallas(port):
    y, z, w = port("probe_overlap_initial_state")
    _, y0, z0 = _k7_mode("a")[0]
    np.testing.assert_array_equal(y, y0)
    np.testing.assert_array_equal(z, z0)
    # w never leaves the JAX kernel; the steps below pin it, and here its
    # closed form
    r = np.arange(128)
    want = jnp.asarray((r[:, None] - r[None, :]).astype(np.float32)
                       * np.float32(1e-3), jnp.bfloat16)
    np.testing.assert_array_equal(w, np.asarray(want, np.float32))


@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("mode", list(K7_MODES))
def test_overlap_chain_matches_pallas(port, mode, steps):
    runs = _k7_mode(mode)
    _, y0, z0 = runs[0]
    o, want_y, want_z = runs[steps]
    w = port("probe_overlap_initial_state")[2]
    y, z, got_o = port("probe_overlap_chain", y0, z0, w,
                       *K7_MODES[mode](steps))
    assert y.shape == (128, M) and z.shape == (8, M) and got_o.shape == o.shape
    np.testing.assert_array_equal(y[:, 128:], want_y[:, 128:])
    y_bound = steps * _bf16_ulp(want_y[:, :128])
    z_bound = steps * 2.0 ** -22 * float(np.abs(want_z).max())
    dy = float(np.abs(y[:, :128] - want_y[:, :128]).max())
    dz = float(np.abs(z - want_z).max())
    do = float(np.abs(got_o - o).max())
    print(f"max |dy| {dy:.3e} of {y_bound:.3e}, |dz| {dz:.3e} of "
          f"{z_bound:.3e}, |do| {do:.3e}")
    assert np.isfinite(want_y).all() and np.isfinite(want_z).all()
    assert dy <= y_bound and dz <= z_bound and do <= y_bound + z_bound
    if mode == "a":
        np.testing.assert_array_equal(z, z0)
    if mode == "b":
        np.testing.assert_array_equal(y, y0)
    else:
        assert not np.array_equal(want_y[:, :128], y0[:, :128])


def test_overlap_both_runs_the_larger_count(port):
    """(3, 2) runs both chains 3 times, in the JAX kernel and in the port:
    the probe's ``if mxu_iters:`` / ``if vpu_iters:`` are truthiness
    tests, so its mode c at (4000, 3000) rolls z 4000 times."""
    (_, y32, z32), (_, y33, z33), (_, _, z22) = _pallas_k7(
        ((3, 2), (3, 3), (2, 2)))
    np.testing.assert_array_equal(y32, y33)
    np.testing.assert_array_equal(z32, z33)
    assert not np.array_equal(z32, z22)
    y0, z0, w = port("probe_overlap_initial_state")
    got = port("probe_overlap_chain", y0, z0, w, 3, 2)
    for a, b in zip(got, port("probe_overlap_chain", y0, z0, w, 3, 3)):
        np.testing.assert_array_equal(a, b)


_SASS_LABELS = """
        Function : _ZN12_GLOBAL__N_114overlap_kernelILb1ELb1EEEvPKtPtPfiff
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
.L_x_3:
        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0030*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0040*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
        /*0050*/                   SHFL.IDX PT, R5, R6, R7, 0x1f ;
        /*0060*/                   FMUL R5, R5, c[0x0][0x22c] ;
        /*0070*/                   FFMA R6, R6, c[0x0][0x228], R5 ;
        /*0080*/              @P0 BRA `(.L_x_3) ;
        /*0090*/              @!P1 BRA `(.L_x_4) ;
        /*00a0*/                   EXIT ;
.L_x_4:
        /*00b0*/                   BRA `(.L_x_4);
"""


def test_loop_counts_reads_sass(port):
    """overlap.loop_counts, which chip_smoke.py applies to the kernel's
    SASS: a backward branch, by label or by address, marks a loop, and the
    instructions from its target to the branch are counted; a forward
    branch does not."""
    loops = port("probe_loop_counts", _SASS_LABELS)
    assert loops[0] == {"insns": 7, "HMMA": 1, "LDSM": 1, "SHFL": 1,
                        "FFMA": 1, "FMUL": 1, "BAR": 1}
    assert [c["insns"] for c in loops] == [7, 1]
    by_address = _SASS_LABELS.replace("`(.L_x_3)", "0x20")
    assert port("probe_loop_counts", by_address) == loops


@functools.lru_cache(maxsize=None)
def _pallas_k4(form):
    """The probe's kernel of one form in interpret mode after 0 to 3 reps,
    each from its own initial state: per rep count (e, d), and the
    weights (9, NCH) and a corner of the planes."""
    reps = STEPS

    def wrapped(*refs):
        n = 2 * len(reps)
        outs, w_out, wpl_out = refs[:n], refs[n], refs[n + 1]
        o_ref = refs[n + 2]
        e_ref, el, er, d_ref, wpl, wdw = refs[n + 3:]
        for i, r in enumerate(reps):
            jdw._kernel(o_ref, e_ref, el, er, d_ref, wpl, wdw, reps=r,
                        form=form)
            outs[2 * i][:] = e_ref[:]
            outs[2 * i + 1][:] = d_ref[:] if r else jnp.zeros((NCH, MP))
        w_out[:] = wdw[:, :, 0]
        wpl_out[:] = wpl[:, :, 0:128]

    shapes = [jax.ShapeDtypeStruct(s, jnp.float32)
              for _ in reps for s in ((NCH, MB), (NCH, MP))]
    shapes += [jax.ShapeDtypeStruct((9, NCH), jnp.float32),
               jax.ShapeDtypeStruct((9, NCH, 128), jnp.float32),
               jax.ShapeDtypeStruct((8, 128), jnp.float32)]
    out = pl.pallas_call(
        wrapped, out_shape=tuple(shapes),
        scratch_shapes=[pltpu.VMEM((NCH, MB), jnp.float32),
                        pltpu.VMEM((NCH, MB), jnp.float32),
                        pltpu.VMEM((NCH, MB), jnp.float32),
                        pltpu.VMEM((NCH, MP), jnp.float32),
                        pltpu.VMEM((9, NCH, MP), jnp.float32),
                        pltpu.VMEM((9, NCH, 1), jnp.float32)],
        interpret=True)()
    out = [np.asarray(a) for a in out]
    states = [tuple(out[2 * i:2 * i + 2]) for i in range(len(reps))]
    return states, out[-3], out[-2], out[-1]


def test_dw_initial_state_matches_pallas(port):
    e, w = port("probe_dw_initial_state")
    states, w_jax, wpl, o = _pallas_k4("scratch")
    e0 = states[0][0]
    np.testing.assert_array_equal(w, w_jax)
    np.testing.assert_array_equal(wpl, np.broadcast_to(
        w_jax[:, :, None], wpl.shape))
    # e = col * 1e-4 - ch * 1e-4: the port rounds each operation; XLA's CPU
    # backend contracts one product into the subtraction, whose result
    # then differs by that product's rounding, at most one f32 ulp of the
    # larger product
    scale = np.maximum(np.arange(MB)[None, :], np.arange(NCH)[:, None]) * 1e-4
    d = np.abs(e - e0)
    print(f"e: {float((d > 0).mean()):.3f} of the values apart, at most "
          f"{float((d / scale.clip(1e-30)).max()):.3e} of the larger product")
    assert (d <= 2.0 ** -23 * scale).all()
    np.testing.assert_array_equal(o, states[3][0][:8, :128])


def _dw_check(got, want, reps):
    (e, d), (we, wd) = got, want
    assert e.shape == (NCH, MB) and d.shape == (NCH, MP)
    d_bound = reps * 9 * 2.0 ** -22 * float(np.abs(wd).max())
    e_bound = 1e-3 * d_bound + 2.0 ** -23 * float(np.abs(we[:, :128]).max())
    dd = float(np.abs(d - wd).max())
    de = float(np.abs(e[:, :128] - we[:, :128]).max())
    print(f"max |dd| {dd:.3e} = {dd / d_bound:.3f} of the bound, |de| "
          f"{de:.3e} = {de / e_bound:.3f}")
    assert np.isfinite(wd).all()
    np.testing.assert_array_equal(e[:, 128:], we[:, 128:])
    assert dd <= d_bound and de <= e_bound


@pytest.mark.parametrize("reps", [1, 2, 3])
@pytest.mark.parametrize("form", FORMS)
def test_dw_chain_matches_pallas(port, form, reps):
    states, w, _, _ = _pallas_k4(form)
    got = port("probe_dw_chain", states[0][0], w, reps, form)
    _dw_check(got, states[reps], reps)


def test_dw_chunked_differs_only_at_chunk_edges(port):
    """chunked's taps roll within each 128-wide chunk: after one rep its d
    differs from scratch's exactly at columns 0 and 127 of every output
    chunk, in the port (bit for bit) and in the JAX kernels (beyond the
    rounding bound there, within it elsewhere)."""
    states, w, _, _ = _pallas_k4("scratch")
    e0 = states[0][0]
    _, ds = port("probe_dw_chain", e0, w, 1, "scratch")
    _, dc = port("probe_dw_chain", e0, w, 1, "chunked")
    diff = (ds != dc).reshape(NCH, -1, 128)
    assert np.nonzero(diff.any(axis=(0, 1)))[0].tolist() == [0, 127]
    assert diff[..., [0, 127]].mean() > 0.99
    js = states[1][1].reshape(NCH, -1, 128)
    jc = _pallas_k4("chunked")[0][1][1].reshape(NCH, -1, 128)
    gap = np.abs(js - jc)
    bound = 9 * 2.0 ** -22 * float(np.abs(js).max())
    assert gap[..., 1:127].max() <= bound
    assert (gap[..., [0, 127]] > bound).mean() > 0.99


def test_dw_flat_forms_are_one_function(port):
    states, w, _, _ = _pallas_k4("scratch")
    base = port("probe_dw_chain", states[0][0], w, 3, "scratch")
    for form in ("value", "planes"):
        for a, b in zip(port("probe_dw_chain", states[0][0], w, 3, form),
                        base):
            np.testing.assert_array_equal(a, b)


def test_wrappers_run_plain_versions_on_cpu(port):
    equal, launched = port("probe_overlap_dw_wrappers_on_cpu")
    assert all(equal.values()), equal
    assert not any(launched.values()), launched


def test_entry_points_raise_without_gpu(port):
    raised = port("probe_overlap_dw_entry_points_without_gpu")
    assert set(raised.values()) == {"RuntimeError"}, raised


@pytest.mark.parametrize("bad", ["dtype", "z_shape", "w_shape", "iters"])
def test_overlap_refuses_bad_input(port, bad):
    with pytest.raises(ValueError):
        port("probe_overlap_bad_input", bad)


@pytest.mark.parametrize("bad", ["dtype", "form", "width", "w_shape",
                                 "reps"])
def test_dw_refuses_bad_input(port, bad):
    with pytest.raises(ValueError):
        port("probe_dw_bad_input", bad)
