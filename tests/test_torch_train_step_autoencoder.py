"""The port's whole training step (train/step.py::build_train_step,
degrade=False) for autoencoder against the JAX package's at crop 32, batch 2, f32
on the CPU, from the same numpy weights and pair (tests/
training_oracles.py: every loss within 1e-5 relative, the gradients
recovered from both Adam states, the new BatchNorm statistics, the step
count, Adam's betas and eps).  The port runs in a
child process (tests/torch_process.py)."""

import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from training_oracles import check_step  # noqa: E402


@pytest.fixture(scope="module")
def step_result():
    with torch_process("torch_side_training") as port:
        yield check_step(port, "autoencoder", 32, 2)


def test_autoencoder_step_matches_jax(step_result):
    case, got = step_result
    print({k: (got["metrics"][k], v) for k, v in case["metrics"].items()})
    assert case["metrics"]["gen_loss"] > 0 and case["metrics"]["disc_loss"] > 0

