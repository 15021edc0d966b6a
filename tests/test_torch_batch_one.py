"""``--batch_size 1`` over several ranks on one host (train/loop.py's
fallback, as the JAX loop's, denoise_gan_tpu/train/loop.py:148-160): two
gloo ranks of the CPU each step the same batch of one unsplit, and

- the trainer's run on them (the autoencoder, crop 32, three images, one
  epoch) ends with both ranks' nets bit-identical, both printing the same
  parameter checksum, and equal to the same run on one process;
- the step they run equals the JAX package's single-device step on the
  same weights and pair, under the training tests' rule (tests/
  training_oracles.py);
- the rule's refusals: several hosts whose global batch the devices do
  not divide raise with the JAX loop's message, as does one host's batch
  above one.
The ranks are spawned by a child process (tests/torch_process.py, tests/
torch_side_parallel.py), started before the JAX step runs here.
"""

import re

import numpy as np
import pytest

from torch_process import TIMEOUT_S, skip_without_torch, torch_process

skip_without_torch()

from training_oracles import (  # noqa: E402
    RTOL, assert_grads_close, assert_trees_close, step_case, step_inputs,
)

FAMILY, CROP, IMAGES = "autoencoder", 32, 3


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_parallel") as call:
        yield call


@pytest.fixture(scope="module")
def runs(port, tmp_path_factory):
    """The ranks' results, started in the child before the JAX step."""
    root = tmp_path_factory.mktemp("batch_one")
    data = root / "data" / "cls"
    data.mkdir(parents=True)
    rng = np.random.default_rng(9)
    for i in range(IMAGES):
        np.save(data / f"im{i}.npy",
                (rng.random((48, 40, 3)) * 255).astype(np.uint8))
    (root / "ranks").mkdir()
    (root / "one").mkdir()
    inputs = step_inputs(FAMILY, CROP, 1)
    started = port.submit("batch_one_ranks", {
        "family": FAMILY, "crop": CROP, "workdir": str(root / "ranks"),
        "one_dir": str(root / "one"),
        "inputs": (inputs["gen"], inputs["disc"], inputs["vgg"],
                   inputs["img_in"], inputs["img_tgt"]),
        "argv": ["--image_dir", str(root / "data"), "--batch_size", "1",
                 "--crop_size", str(CROP), "--epochs", "1", "--device",
                 "cpu"]})
    case = step_case(FAMILY, CROP, 1)
    return started.result(TIMEOUT_S), case


def test_ranks_equal_one_process(runs):
    ranks, _ = runs
    a, b = (r["run"] for r in ranks)
    one = ranks[0]["one_process"]
    assert a["step"] == b["step"] == one["step"] == IMAGES
    assert a["digest"] == b["digest"] == one["digest"]
    sums = [re.findall(r"rank (\d) of 2: parameter checksum (\S+)",
                       r["stdout"]) for r in (a, b)]
    assert [s[0][0] for s in sums] == ["0", "1"]
    assert sums[0][0][1] == sums[1][0][1]
    assert "parameter checksum" not in one["stdout"]


def test_step_matches_jax_single_device(runs):
    ranks, case = runs
    for r in ranks:
        got = r["step"]
        for k, w in case["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], w, rtol=RTOL,
                                       atol=1e-8, err_msg=k)
        assert got["step"] == 1
        assert_trees_close(got["gen_stats"], case["gen_stats"])
        assert_trees_close(got["disc_stats"], case["disc_stats"])
        assert_grads_close(got["gen_grads"], case["gen_grads"])
        assert_grads_close(got["disc_grads"], case["disc_grads"])
    assert ranks[0]["step"]["digest"] == ranks[1]["step"]["digest"]


@pytest.mark.parametrize("batch, hosts, ranks, want", [
    (1, 1, 2, (1, False)), (1, 1, 3, (1, False)), (4, 1, 2, (4, True)),
    (2, 2, 2, (4, True)), (1, 2, 4, "multi-host training requires the "
     "global batch (1 per host x 2 hosts = 2) to be divisible by the 4 "
     "devices; adjust --batch_size"),
    (3, 1, 2, "global batch 3 not divisible by 2 devices")])
def test_batch_rule(port, batch, hosts, ranks, want):
    got = port("batch_split", batch, hosts, ranks)
    assert (tuple(got) if isinstance(got, (list, tuple)) else got) == want
