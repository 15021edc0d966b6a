"""The port's kernel engines against the JAX package's on a trained export,
each against the exact whole-frame output, on the CPU:

    python tests/trained_rule_check.py fsrgan models/fsrgan_4x_50q.dgt

For each mode (bf16, w8a8, qh8; the int8 modes calibrated on the frame)
it prints the share of bytes more than one level from the exact output,
for the port (its twins, tests/torch_side.py::whole_frame_and_engines)
and for the JAX package (its Pallas tails in interpret mode,
tests/test_torch_quality_rule.py::_jax_frames), and the two engines'
distance, at test_torch_quality_rule.py's 135x240 noise frame.  It tells
a fault of the port from one of the weights and modes on weights the
tests do not hold (the quality table's, say: PERF.md section 6, PR 18).
No test runs this script; it is named so that pytest does not collect it.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(family: str, path: str) -> None:
    import jax
    import jax.numpy as jnp

    import test_torch_quality_rule as rule
    from denoise_gan_tpu.io import checkpoint as jck
    from denoise_gan_tpu.models import build_models
    from torch_process import TIMEOUT_S, torch_process

    gen = build_models(family, scale=4).generator
    v = jax.eval_shape(lambda: gen.init(
        jax.random.key(0), jnp.zeros((1, 16, 16, 3)), train=False))
    zeros = lambda t: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), t)
    _, params, stats = jck.load_export_into(path, zeros(v["params"]),
                                            zeros(v["batch_stats"]))
    params, stats = (jax.tree.map(np.asarray, t) for t in (params, stats))
    with torch_process() as port:
        future = port.submit("whole_frame_and_engines", params, stats,
                             rule._noise_frame(), rule.BRC, family=family)
        jax_outs = rule._jax_frames(family, params, stats)
        exact, outs = future.result(TIMEOUT_S)
    for mode, want in jax_outs.items():
        d_jax = np.abs(want.astype(np.int32) - exact)
        d_port = np.abs(outs[mode].astype(np.int32) - exact)
        d = np.abs(outs[mode].astype(np.int32) - want)
        print(f"{family} {mode} vs exact: port max {d_port.max()} > 1 on "
              f"{(d_port > 1).mean():.5f}, JAX max {d_jax.max()} > 1 on "
              f"{(d_jax > 1).mean():.5f}; port vs JAX max {d.max()} > 1 "
              f"on {(d > 1).mean():.5f}")


if __name__ == "__main__":
    main(*sys.argv[1:3])
