"""pix2pix's share of the training step in the port against the JAX
package, by its parts (the whole step at crop 256 does not fit the CPU
suite's time: its VGG19 at 256^2 in both packages is most of the cost;
the card runs the whole step, chip_smoke.py phase 4g and tests/
test_torch_cuda.py).  The parts, f32 on the CPU:
- the generator's two passes at crop 256, batch 1: the main pass on the
  input (its BatchNorm statistics kept) and the identity pass on the
  target (its statistics thrown away, models/layers.py::
  batch_stats_frozen), each with the dropout masks that Flax drew (taken
  by intercepting flax.linen.Dropout), the gradient of both L1 losses;
- the discriminator's half at 64: D(input, target) then D(input, fake),
  the statistics chaining from the first pass into the second, the BCE
  from logits;
- Adam's b1 0.5 and the constant 2e-4 (tests/test_torch_train_data.py).
Tolerances as tests/training_oracles.py's.  The passes need the step's
precision context: with oneDNN's CPU convolutions their gradients lie far
outside the rule (``python tests/training_oracles.py`` reads them).  The
whole step
at 256 is ill-conditioned in f32 whoever computes it (``python
tests/training_oracles.py`` reads its f32 gradients against float64): a
leaky-ReLU kink or a max pool's near-tie that f32 rounds to either side
moves a gradient summed over many positions by a step, and BatchNorm's
E[x^2] - mean^2 cancels where a channel's mean dwarfs its spread.  The
port runs in a child process (tests/torch_process.py).
"""

import jax
import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.losses.gan import discriminator_loss  # noqa: E402
from denoise_gan_tpu.models import discriminators as jdisc  # noqa: E402
from training_oracles import (  # noqa: E402
    RTOL, assert_grads_close, assert_trees_close, draw, dropout_masks,
    pix2pix_passes_case,
)


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_training") as call:
        yield call


@pytest.fixture(scope="module")
def passes(port):
    """JAX's and the port's two generator passes on the same weights,
    input, target and masks."""
    want = pix2pix_passes_case()
    return want, port("pix2pix_passes", *want["inputs"], want["masks"])


def test_pix2pix_generator_passes_match_jax(passes):
    want, got = passes
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
    for k in ("out", "ident"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                   atol=RTOL * np.abs(want[k]).max(),
                                   err_msg=k)
    assert_trees_close(got["stats"], want["stats"])
    assert_grads_close(got["grads"], want["grads"])


def test_pix2pix_dropout_masks_and_identity(passes):
    """JAX drew six dropout masks, three for the main pass and three for
    the identity pass (each about half kept, the two passes apart); the
    port's identity pass left the main pass's statistics as they were
    (checked with them above) and differs from its main pass."""
    want, got = passes
    main, ident = want["masks"]
    assert len(main) == len(ident) == 3
    for a, b in zip(main, ident):
        assert 0.4 < a.mean() < 0.6 and (a != b).any()
    assert not np.allclose(got["out"], got["ident"])


def test_pix2pix_disc_half_matches_jax(port):
    """D(input, target) then D(input, fake), the running statistics
    chaining from the first pass into the second, the BCE from logits:
    loss, new statistics and gradients to the full rule, at 64."""
    rng = np.random.default_rng(21)
    model = jdisc.ConditionalPatchDiscriminator()
    img_in, img_tgt, fake = ((rng.random((2, 64, 64, 3)) * 2 - 1).astype(
        np.float32) for _ in range(3))
    v = jax.eval_shape(lambda: model.init(jax.random.key(0), img_in,
                                          img_tgt, train=False))
    params, stats = draw(v["params"], rng), draw(v["batch_stats"], rng)

    @jax.jit
    def oracle(p):
        def loss_fn(p):
            real, mut = model.apply({"params": p, "batch_stats": stats},
                                    img_in, img_tgt, train=True,
                                    mutable=["batch_stats"])
            fk, mut = model.apply({"params": p, **mut}, img_in, fake,
                                  train=True, mutable=["batch_stats"])
            return discriminator_loss(real, fk, True), mut["batch_stats"]
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    (loss, new_stats), grads = oracle(params)
    got_loss, got_stats, got_grads = port("disc_step_part", params, stats,
                                          img_in, img_tgt, fake)
    np.testing.assert_allclose(got_loss, float(loss), rtol=RTOL)
    assert_trees_close(got_stats, new_stats)
    assert_grads_close(got_grads, grads)
