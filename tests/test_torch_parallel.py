"""The port's data parallelism (denoise_gan_tpu_torch/parallel/mesh.py) on
two gloo ranks of the CPU against the JAX package's mesh and against the
port on one process:

- the autoencoder and FSRGAN steps (crop 32, global batch 4, 2 rows a
  rank, f32, degrade=False) against the JAX step on the global batch and
  against the port's one-process step, under the training tests' rule
  (tests/training_oracles.py: losses 1e-5 relative, gradients cosine
  0.9999 and max |d| <= 1e-3 max |g|, BatchNorm statistics 1e-5); the
  nets bit-identical across the ranks after the step;
- the frame engine with its tile batch split over the ranks against the
  JAX engine over an 8-device mesh (tests/test_parallel.py's forward),
  atol 1e-5;
- the FSRGAN kernel engine frame-parallel (one 64x70 frame a rank, the
  tail's twin on the CPU): byte-equal to the port's engine on one
  process, within the engine's bf16 envelope of the JAX engine on one
  device in interpret mode;
- the space axis (parallel/spatial.py::spatial_apply, a frame's rows
  split over the two ranks, each conv's halo exchanged): FSRGAN at the
  JAX test's 64x64 input with its init weights (tests/test_parallel.py)
  and SRGAN at 48x40 (JAX init weights too) against the JAX package's
  GSPMD forward over the 8-device CPU mesh (spatial_sharding), atol 1e-4;
  those, SRGAN at 45 rows (an uneven 22/23 split) and the autoencoder at
  64x64 (32/32) against the port's forward on one process, within 1e-5
  (byte-equality printed); one halo exchange a SAME conv wider than 1x1;
  the gathered frame equal on both ranks; pix2pix and an autoencoder
  split into 48-row shares refused; make_mesh's (data, space) layout and
  batch_sharding's shards against the JAX mesh's;
- a resumed run's agreement on the checkpoint (train/loop.py::
  resume_step);
- the random draws over the global batch, DataPipeline's shards against
  the JAX pipeline's, make_mesh's refusals, and the trainer's dry run
  under torchrun (parallel/dryrun.py).
The port runs in two child processes (tests/torch_process.py): one spawns
the ranks, the other runs the dry run beside it, and both start before
the JAX oracles run here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_process import TIMEOUT_S, skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.data.pipeline import DataPipeline  # noqa: E402
from denoise_gan_tpu.infer import kernel_engine as jke  # noqa: E402
from denoise_gan_tpu.infer.engine import build_frame_engine  # noqa: E402
from denoise_gan_tpu.models import build_models  # noqa: E402
from denoise_gan_tpu.models.autoencoder import (  # noqa: E402
    AutoencoderGenerator,
)
from denoise_gan_tpu.models.fsrgan import FSRGANGenerator  # noqa: E402
from denoise_gan_tpu.parallel.mesh import (  # noqa: E402
    batch_sharding, make_mesh, spatial_sharding,
)
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402
from denoise_gan_tpu.utils.config import make_config  # noqa: E402
from training_oracles import (  # noqa: E402
    RTOL, assert_grads_close, assert_trees_close, draw, step_case,
    step_inputs,
)

CROP, BATCH = 32, 4
FAMILIES = ("autoencoder", "fsrgan")
EH, EW = 48, 80            # the tile-split engine (tests/test_parallel.py)
KH, KW, KBRC = 64, 70, 8   # the frame-parallel kernel engine
SPACE_JAX_ATOL = 1e-4      # tests/test_parallel.py:58-59
SPACE_ONE_ATOL = 1e-5


def _engine_case():
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((3, 12)) * 0.3).astype(np.float32)
    frame = np.random.default_rng(0).random((EH, EW, 3)).astype(np.float32)
    return dict(w=w, frame=frame, height=EH, width=EW, scale=2, tile=16,
                overlap=4)


@pytest.fixture(scope="module")
def kernel_case():
    v = jax.eval_shape(lambda: FSRGANGenerator().init(
        jax.random.key(0), jnp.zeros((1, 16, 16, 3)), train=False))
    rng = np.random.default_rng(7)
    params, stats = draw(v["params"], rng), draw(v["batch_stats"], rng)
    frames = [rng.random((KH, KW, 3)).astype(np.float32) for _ in range(2)]
    return dict(params=params, stats=stats, height=KH, width=KW, brc=KBRC,
                frames=frames)


@pytest.fixture(scope="module")
def spatial_cases():
    """{name: (family, scale, params, stats, NHWC frame)}: FSRGAN as
    tests/test_parallel.py draws it (its rng's first draw, Flax init from
    keys 0 and 1, jitted); SRGAN drawn with numpy (its Flax init's output
    is ~1e-3 wide, too flat to hold to 1e-4), the residual blocks' kernels
    at a tenth as chip_smoke.py seeds them, at 48x40 and on a 45-row
    frame; the autoencoder drawn with numpy at 64x64."""
    x64 = np.random.default_rng(0).uniform(-1, 1, (1, 64, 64, 3)).astype(
        np.float32)
    gen = FSRGANGenerator()
    v = jax.jit(lambda k, a: gen.init(k, a, train=False))(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, x64)
    out = {"fsrgan": ("fsrgan", 4, *jax.tree.map(
        np.asarray, (v["params"], v["batch_stats"])), x64)}
    rng = np.random.default_rng(4)
    shapes = jax.eval_shape(lambda: build_models("srgan").generator.init(
        jax.random.key(0), jnp.zeros((1, 8, 8, 3)), train=False))
    params, stats = draw(shapes["params"], rng), draw(shapes["batch_stats"],
                                                      rng)
    for name, conv in params["body"].items():
        if name.startswith("Conv_") and name != "Conv_0":
            conv["kernel"] *= np.float32(0.1)
    for name, rows in (("srgan", 48), ("srgan-45", 45)):
        out[name] = ("srgan", 4, params, stats, rng.uniform(
            -1, 1, (1, rows, 40, 3)).astype(np.float32))
    shapes = jax.eval_shape(lambda: AutoencoderGenerator().init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False))
    out["autoencoder"] = ("autoencoder", 1, draw(shapes["params"], rng), {},
                          rng.uniform(-1, 1, (1, 64, 64, 3)).astype(
                              np.float32))
    return out


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_parallel", workers=2) as call:
        yield call


@pytest.fixture(scope="module")
def started(port, kernel_case, spatial_cases, tmp_path_factory):
    """The port's runs, started in the children at once (the ranks' session
    and the dry run first): their futures."""
    inputs = {f: _inputs(step_inputs(f, CROP, BATCH)) for f in FAMILIES}
    k = kernel_case
    return {
        "ranks": port.submit(
            "two_ranks", {"steps": {f: (CROP, i) for f, i in inputs.items()},
                          "engine": _engine_case(), "kernel_engine": k,
                          "spatial": spatial_cases}),
        "dry_run": port.submit("dry_run",
                               str(tmp_path_factory.mktemp("dry_run"))),
        **{f: port.submit("one_process_step", f, CROP, i)
           for f, i in inputs.items()},
        "kernel_engine": port.submit(
            "engine_with_plan", "fsrgan", k["params"], k["stats"], KH, KW,
            KBRC, None, k["frames"]),
        "spatial": port.submit("spatial_one_process", spatial_cases),
        "layout": port.submit("mesh_layout", 8, 2, (8, 16, 4, 3)),
    }


@pytest.fixture(scope="module")
def cases(started):
    """The JAX steps, run here while the port's runs go on."""
    return {f: step_case(f, CROP, BATCH) for f in FAMILIES}


@pytest.fixture(scope="module")
def ranks(started, cases, gspmd):
    return started["ranks"].result(TIMEOUT_S)


def _inputs(i):
    return (i["gen"], i["disc"], i["vgg"], i["img_in"], i["img_tgt"])


def _check(got, want_metrics, want):
    """The training tests' rule (tests/training_oracles.py::check_step)."""
    for k, w in want_metrics.items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=RTOL,
                                   atol=1e-8, err_msg=k)
    assert got["step"] == 1
    assert_trees_close(got["gen_stats"], want["gen_stats"])
    assert_trees_close(got["disc_stats"], want["disc_stats"])
    assert_grads_close(got["gen_grads"], want["gen_grads"])
    assert_grads_close(got["disc_grads"], want["disc_grads"])


def test_mesh(ranks, port):
    for r, out in enumerate(ranks):
        assert out["mesh"] == (2, r, "cpu", 1)
        # num_devices 1 and 3 under 2 ranks refused; space 2 divides the
        # ranks and gives the (1, 2) mesh; space 3 does not divide
        assert out["mesh_errors"] == ["ValueError", "ValueError", "none",
                                      "ValueError"]
        assert out["space_mesh"] == (2, r, 2, 0, r)
    assert port("no_group_mesh_errors") == ["ValueError", "ValueError"]


def test_mesh_layout_matches_jax(started):
    """make_mesh's layout, (ranks // space, space): a rank's (data, space)
    indices are its device's position in the JAX make_mesh(8, space=2),
    and batch_sharding gives it the slices of axes 0 and 1 that the JAX
    batch_sharding gives that device."""
    mesh = make_mesh(8, space=2)
    want = batch_sharding(mesh).devices_indices_map((8, 16, 4, 3))
    got = started["layout"].result(TIMEOUT_S)
    for d, row in zip(mesh.devices.flat, got):
        assert tuple(int(i) for i in np.argwhere(mesh.devices == d)[0]) \
            == row[:2]
        s0, s1 = want[d][:2]
        assert (s0.start, s0.stop) == row[2] and (s1.start, s1.stop) == \
            row[3]


@pytest.fixture(scope="module")
def gspmd(started, spatial_cases):
    """The JAX package's GSPMD forward of the FSRGAN and SRGAN cases over
    the 8-device CPU mesh, H sharded (tests/test_parallel.py's way), run
    here while the ranks run."""
    sharding = spatial_sharding(make_mesh(8))
    out = {}
    for name in ("fsrgan", "srgan"):
        family, scale, params, stats, x = spatial_cases[name]
        gen = build_models(family, scale=scale).generator
        x_sharded = jax.device_put(jnp.asarray(x), sharding)
        assert len(x_sharded.sharding.device_set) == 8
        out[name] = np.asarray(jax.jit(
            lambda v, a: gen.apply(v, a, train=False),
            in_shardings=(NamedSharding(sharding.mesh, P()), sharding))(
                {"params": params, "batch_stats": stats}, x_sharded))
    return out


@pytest.mark.parametrize("name", ["fsrgan", "srgan"])
def test_space_axis_matches_jax_gspmd(ranks, gspmd, name):
    want = gspmd[name]
    assert np.std(want) > 0.01
    for out in ranks:
        got = out["spatial"][name]
        np.testing.assert_allclose(got["whole"], want, rtol=0,
                                   atol=SPACE_JAX_ATOL)
        lo, hi = got["range"]
        np.testing.assert_allclose(got["rows"], want[:, 4 * lo:4 * hi],
                                   rtol=0, atol=SPACE_JAX_ATOL)


@pytest.mark.parametrize("name", ["fsrgan", "srgan", "srgan-45",
                                  "autoencoder"])
def test_space_axis_matches_one_process(ranks, started, spatial_cases,
                                        name):
    """Each rank's rows against the port's forward on one process (byte-
    equality printed), one halo exchange a conv wider than 1x1 (FSRGAN
    11, SRGAN 36, the autoencoder 17), the gathered frames equal."""
    family, scale, _, _, x = spatial_cases[name]
    one = started["spatial"].result(TIMEOUT_S)[name]
    assert one.shape == (1, x.shape[1] * scale, x.shape[2] * scale, 3)
    n = x.shape[1]
    want_ranges = [(0, n // 2), (n // 2, n)]
    for r, out in enumerate(ranks):
        got = out["spatial"][name]
        assert got["range"] == want_ranges[r]
        assert got["exchanges"] == {"fsrgan": 11, "srgan": 36,
                                    "autoencoder": 17}[family]
        lo, hi = got["range"]
        want = one[:, scale * lo:scale * hi]
        print(f"{name} rank {r}: rows {lo}:{hi}, max |d| "
              f"{np.abs(got['rows'] - want).max():.2e}, byte-equal "
              f"{np.array_equal(got['rows'], want)}")
        np.testing.assert_allclose(got["rows"], want, rtol=0,
                                   atol=SPACE_ONE_ATOL)
        np.testing.assert_allclose(got["whole"], one, rtol=0,
                                   atol=SPACE_ONE_ATOL)
    np.testing.assert_array_equal(ranks[0]["spatial"][name]["whole"],
                                  ranks[1]["spatial"][name]["whole"])


def test_space_axis_refusals(ranks):
    """pix2pix (NotImplementedError) and an autoencoder frame whose
    shares are not multiples of 32 rows (ValueError) raise on both ranks
    before any exchange."""
    for out in ranks:
        assert out["spatial"]["refused"] == ["NotImplementedError",
                                             "ValueError"]


def test_resume_needs_the_checkpoint_on_every_rank(ranks):
    """train/loop.py::resume_step: the step where every rank finds it; a
    RuntimeError on both ranks where only rank 0 does (its optimizer state
    would otherwise be rank 0's alone); None without checkpoints."""
    for out in ranks:
        assert out["resume"] == [5, "RuntimeError", None]


@pytest.mark.parametrize("family", FAMILIES)
def test_two_rank_step_matches_jax(ranks, cases, family):
    case = cases[family]
    _check(ranks[0]["steps"][family], case["metrics"], case)


@pytest.mark.parametrize("family", FAMILIES)
def test_two_rank_step_matches_one_process(ranks, started, family):
    one = started[family].result(TIMEOUT_S)
    _check(ranks[0]["steps"][family], one["metrics"], one)


@pytest.mark.parametrize("family", FAMILIES)
def test_ranks_bit_identical_after_step(ranks, family):
    a, b = (r["steps"][family] for r in ranks)
    assert a["digest"] == b["digest"]
    assert a["metrics"] == b["metrics"]


def test_tile_split_engine_matches_jax_mesh(ranks):
    e = _engine_case()
    w = jnp.asarray(e["w"])

    def fwd(x):
        return jnp.tanh(x @ w)

    eng8 = build_frame_engine(fwd, EH, EW, 2, tile=16, overlap=4,
                              mesh=make_mesh(8))
    want = np.asarray(eng8(jnp.asarray(e["frame"])))
    for out in ranks:
        assert out["engine"].shape == (EH * 2, EW * 2, 3)
        np.testing.assert_allclose(out["engine"], want, atol=1e-5)
    np.testing.assert_array_equal(ranks[0]["engine"], ranks[1]["engine"])


def test_frame_parallel_kernel_engine(ranks, kernel_case, started):
    """Each rank's frame byte-equal to the port's engine on one process,
    and within the engine's bf16 envelope of the JAX engine on one device
    (max 1 level on < 1e-3 of the bytes, tests/test_torch_engine.py: the
    bf16 body rounds apart in XLA and PyTorch, so the port's engine is
    not byte-equal to JAX's on one process either; 3.8e-4 here)."""
    k = kernel_case
    one = started["kernel_engine"].result(TIMEOUT_S)
    eng = jke.build_fsrgan_kernel_engine(k["params"], k["stats"], KH, KW,
                                         brc=KBRC, interpret=True)
    for r, out in enumerate(ranks):
        got = out["kernel_engine"]
        assert got.shape == (1, KH * 4, KW * 4, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got[0], one[r])
        want = np.asarray(jke.flat_view(eng(jnp.asarray(k["frames"][r])),
                                        KH, KW)).reshape(KH * 4, KW * 4, 3)
        d = np.abs(got[0].astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(),
                                                        (d > 0).mean())


def test_global_draws_sliced(port):
    r = port("sliced_draws")
    assert r == {"qualities": True, "masks": True, "local_differs": True}


def test_pipeline_shards_match_jax(port, tmp_path):
    d = tmp_path / "cls"
    d.mkdir()
    for i in range(9):
        np.save(d / f"im{i}.npy", np.zeros((8, 8, 3), np.uint8))
    cfg = make_config("fsrgan", image_dir=str(tmp_path), batch_size=2)
    for index, count in ((0, 2), (1, 2), (2, 3)):
        want = DataPipeline(cfg, process_index=index, process_count=count)
        paths, size, steps = port("pipeline_shard", str(tmp_path), index,
                                  count)
        assert paths == want.paths and size == want.train_size
        assert steps == len(want)


def test_dry_run(started):
    r = started["dry_run"].result(TIMEOUT_S)
    assert r["ranks"] == 2 and np.isfinite(r["disc_loss"])
