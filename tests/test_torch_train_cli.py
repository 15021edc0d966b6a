"""The port's trainers end to end on the CPU (train_<family>_torch.py ->
train/loop.py::main with --device cpu) on seeded .npy images: FSRGAN for
two epochs, whose exports the JAX package's read_export and
load_export_into read back equal to the port's final state (generator and
discriminator), which the port reads back too, and whose last checkpoint
restores to an equal state; a warm start of the port from the JAX
package's exports; the autoencoder for an epoch (SRGAN, bf16, and
pix2pix, whose crop is 256, train through their CLIs on the card:
chip_smoke.py phase 4g); the refusals (a CUDA run without a GPU,
--num_devices 2).  The port runs in three child processes
(tests/torch_process.py), every run of it started at once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.io import checkpoint as jck  # noqa: E402
from denoise_gan_tpu.models import build_models  # noqa: E402
from training_oracles import draw, flat  # noqa: E402

FSRGAN_ARGV = ["--device", "cpu", "--image_dir", "data", "--epochs", "2",
               "--batch_size", "2", "--crop_size", "32", "--save_iter", "1",
               "--max_to_keep", "1", "--data_workers", "2"]


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_training", workers=3) as call:
        yield call


def seed_images(root, n, size):
    d = root / "data" / "cls"
    d.mkdir(parents=True)
    rng = np.random.default_rng(n)
    for i in range(n):
        np.save(d / f"im{i}.npy",
                (rng.random((size + 3 * i, size + 8, 3)) * 255).astype(
                    np.uint8))


def templates(family, crop):
    """Zero numpy trees of the family's generator and discriminator, from
    jax.eval_shape."""
    bundle = build_models(family, scale=4 if family in ("srgan", "fsrgan")
                          else 1)
    lr = crop // 4 if bundle.upscales else crop
    gv = jax.eval_shape(lambda: bundle.generator.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((1, lr, lr, 3)), train=False))
    dv = jax.eval_shape(lambda: bundle.discriminator.init(
        jax.random.key(0), jnp.zeros((1, crop, crop, 3)), train=False))
    zeros = lambda t: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), t)
    return ((zeros(gv["params"]), zeros(gv.get("batch_stats", {}))),
            (zeros(dv["params"]), zeros(dv["batch_stats"])))


def assert_trees_equal(got, want):
    got, want = dict(flat(got)), dict(flat(want))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@functools.lru_cache(maxsize=None)
def fsrgan_templates():
    return templates("fsrgan", 32)


def warm_start_trees():
    """Seeded generator and discriminator trees of FSRGAN."""
    rng = np.random.default_rng(4)
    (gp, gs), (dp, ds) = fsrgan_templates()
    return (draw(gp, rng), draw(gs, rng)), (draw(dp, rng), draw(ds, rng))


# (family, crop, images) of test_other_trainers_run
OTHER = [("autoencoder", 32, 2)]


@pytest.fixture(scope="module")
def started(port, tmp_path_factory):
    """The port's runs, started in the children at once, in the order the
    tests read them: {case: (work directory, future)}."""
    runs = {}
    root = tmp_path_factory.mktemp("train")
    seed_images(root, 4, 40)
    runs["fsrgan"] = root, port.submit("trainer_cli", str(root), FSRGAN_ARGV)

    root = tmp_path_factory.mktemp("warm")
    name = "fsrgan_4x_50q"
    gen, disc = warm_start_trees()
    jck.export_net(str(root / "models" / f"{name}.dgt"), "fsrgan", 4, *gen)
    jck.export_net(str(root / "models" / f"{name}_disc.dgt"), "fsrgan", 4,
                   *disc, role="discriminator")
    runs["warm"] = root, port.submit("warm_start", str(root), "fsrgan", name,
                                     gen, disc)
    for family, crop, images in OTHER:
        root = tmp_path_factory.mktemp(family)
        seed_images(root, images, crop)
        argv = ["--device", "cpu", "--image_dir", "data", "--batch_size",
                "1", "--crop_size", str(crop), "--data_workers", "1"]
        runs[family] = root, port.submit("trainer_cli", str(root), argv,
                                         family)
    return runs


@pytest.fixture(scope="module")
def fsrgan_run(started):
    root, future = started["fsrgan"]
    return root, future.result()


def test_fsrgan_trainer_runs(fsrgan_run):
    _, out = fsrgan_run
    epochs = [l for l in out["stdout"].splitlines() if "Starting epoch" in l]
    assert len(epochs) == 2 and "iters: 4," in epochs[-1]
    for line in epochs:
        for part in line.split(", ")[1:6]:
            assert np.isfinite(float(part.split(": ")[1])), line
    assert "Steps per epoch: 2" in out["stdout"]


def test_jax_reads_the_port_exports(fsrgan_run):
    """The JAX package's read_export and load_export_into read
    models/<name>.dgt and <name>_disc.dgt back equal to the final state."""
    root, out = fsrgan_run
    name = "fsrgan_4x_50q"
    (gp, gs), (dp, ds) = fsrgan_templates()
    for path, role, (p, s), want in (
            (f"models/{name}.dgt", "generator", (gp, gs), out["gen"]),
            (f"models/{name}_disc.dgt", "discriminator", (dp, ds),
             out["disc"])):
        config, params, stats = jck.load_export_into(str(root / path), p, s)
        assert config == {"family": "fsrgan", "scale": 4, "format": 1,
                          "role": role}
        assert_trees_equal(params, want[0])
        assert_trees_equal(stats, want[1])
    assert len(list((root / "models" / "backups" / name).glob("*.dgt"))) == 1


def test_port_reads_its_exports_and_checkpoint(fsrgan_run):
    """The exports read into fresh nets, and the last checkpoint restored
    into a fresh state, equal the final state (step 4, epoch 2);
    max_to_keep 1 keeps one checkpoint."""
    _, out = fsrgan_run
    assert out["export_diff"] == ([], [])
    diff, opt_equal, step, epoch, want_step, want_epoch = out["restore"]
    assert diff == [] and opt_equal
    assert (step, epoch) == (want_step, want_epoch) == (4, 2)
    assert out["kept"] == [4]
    assert [c["role"] for c in out["configs"]] == ["generator",
                                                   "discriminator"]


def test_port_warm_starts_from_jax_exports(started):
    """--retrain with no checkpoint loads models/<name>.dgt and
    <name>_disc.dgt written by the JAX package's export_net."""
    assert started["warm"][1].result() == ([], [])


@pytest.mark.parametrize("family, crop, images", OTHER)
def test_other_trainers_run(started, family, crop, images):
    """One epoch of the family at its own defaults writes both exports,
    which read back equal to the final state."""
    out = started[family][1].result()
    assert out["export_diff"] == ([], [])
    assert out["restore"][2] == images
    line = [l for l in out["stdout"].splitlines() if "Starting epoch" in l]
    assert len(line) == 1 and "nan" not in line[0]


def test_trainer_refusals(port, tmp_path):
    """Without --device the trainer asks for the card and, with no GPU,
    raises; --num_devices 2 in a run of one process raises, naming
    torchrun (one process a device)."""
    seed_images(tmp_path, 2, 32)
    base = ["--image_dir", str(tmp_path / "data"), "--crop_size", "32"]
    kind, msg = port("trainer_refusal", base)
    assert kind == "RuntimeError" and "CUDA" in msg
    kind, msg = port("trainer_refusal", base + ["--device", "cpu",
                                                "--num_devices", "2"])
    assert kind == "ValueError" and "torchrun --nproc_per_node=2" in msg
