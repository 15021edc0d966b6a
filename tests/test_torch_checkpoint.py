"""``.dgt`` exports between the JAX package and the port
(denoise_gan_tpu_torch/io/checkpoint.py, io/flax_msgpack.py,
io/params.py::to_jax_trees).  The port runs in a child process
(tests/torch_process.py).

- A file of the JAX package's export_generator, read by the port's
  load_generator, gives tensors equal to from_jax_params on the same
  trees; a file of the port's export_generator, read by the JAX package
  (read_export and load_generator, or load_export_into with templates
  from jax.eval_shape), gives trees equal to the originals.  Families:
  pix2pix (BatchNorm, ConvTranspose) and FSRGAN and SRGAN 4x (the
  upscalers); to_jax_trees inverts from_jax_params for the autoencoder
  and the upscalers.  Tolerance: exact.
- The port's msgpack encoder writes the bytes flax writes for the same
  tree, and its decoder reads flax's bytes back to equal leaves; a bf16
  leaf loads as its values.
- Refusals: a discriminator export, a file without the magic, a truncated
  HDF5 file (sent to the .h5 reader, whose message names the structure it
  could not read), a chunked leaf, and a CUDA request without a GPU.
Flax leaves are drawn with numpy; tree shapes come from jax.eval_shape
(an eager Flax init costs seconds).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

from flax import serialization  # noqa: E402

from denoise_gan_tpu.io import checkpoint as jck  # noqa: E402
from denoise_gan_tpu.models import autoencoder as jae  # noqa: E402
from denoise_gan_tpu.models import fsrgan as jfsrgan  # noqa: E402
from denoise_gan_tpu.models import pix2pix as jp2p  # noqa: E402
from denoise_gan_tpu.models import srgan as jsrgan  # noqa: E402

# (family, scale, Flax generator, input size of the shape trace)
FAMILIES = {"autoencoder": (1, jae.AutoencoderGenerator(), 32),
            "pix2pix": (1, jp2p.Pix2PixGenerator(), 256),
            "fsrgan": (4, jfsrgan.FSRGANGenerator(), 16),
            "srgan": (4, jsrgan.SRGANGenerator(scale=4), 16)}


def _shapes(family):
    _, gen, size = FAMILIES[family]
    v = jax.eval_shape(lambda: gen.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((1, size, size, 3)), train=False))
    return v["params"], v.get("batch_stats", {})


def _draw(tree, rng):
    return {k: _draw(v, rng) if hasattr(v, "items") else
            rng.standard_normal(v.shape).astype(np.float32)
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _trees(family, seed=0):
    """Drawn once per module (pix2pix's 54 M parameters take a second)."""
    rng = np.random.default_rng(seed)
    return tuple(_draw(t, rng) for t in _shapes(family))


def _assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_serving") as call:
        yield call


@pytest.mark.parametrize("family", ["pix2pix", "fsrgan", "srgan"])
def test_jax_export_loads_in_port(port, tmp_path, family):
    scale = FAMILIES[family][0]
    params, stats = _trees(family)
    path = str(tmp_path / f"{family}.dgt")
    jck.export_generator(path, family, scale, params, stats)
    config, differ, dtype = port("load_matches_trees", path, params, stats)
    assert config == {"family": family, "scale": scale, "format": 1,
                      "role": "generator"}
    assert differ == [] and dtype == "torch.float32"


@pytest.mark.parametrize("family", ["pix2pix", "fsrgan"])
def test_port_export_loads_in_jax(port, tmp_path, family):
    """FSRGAN through the JAX package's load_generator itself (its eager
    init takes seconds), pix2pix through read_export + load_export_into
    with eval_shape templates (its eager init takes ~12 s)."""
    scale = FAMILIES[family][0]
    params, stats = _trees(family)
    path = str(tmp_path / f"{family}.dgt")
    port("export_from_trees", path, family, scale, params, stats)
    config, _ = jck.read_export(path)
    assert config == {"family": family, "scale": scale, "format": 1,
                      "role": "generator"}
    if family == "fsrgan":
        config, got_p, got_s = jck.load_generator(path)
    else:
        config, got_p, got_s = jck.load_export_into(path, *_shapes(family))
    _assert_trees_equal(got_p, params)
    _assert_trees_equal(got_s, stats)


@pytest.mark.parametrize("family", ["autoencoder", "fsrgan", "srgan"])
def test_to_jax_trees_inverts_from_jax_params(port, family):
    """pix2pix's (ConvTranspose) inverse is held by the export test."""
    params, stats = _trees(family)
    got_p, got_s = port("trees_round_trip", family, FAMILIES[family][0],
                        params, stats)
    _assert_trees_equal(got_p, params)
    _assert_trees_equal(got_s, stats)


def test_msgpack_matches_flax(port):
    """Byte equality with flax.serialization.to_bytes, and flax's bytes
    decoded to equal leaves: f32, int64, bool, a numpy scalar (ext type 3),
    a 0-d and an empty array, bf16, maps of 16 keys and more (map16) and
    leaves of 2**16 bytes and more (bin32/ext32)."""
    rng = np.random.default_rng(3)
    tree = {"params": {
        "a": {"kernel": rng.standard_normal((3, 3, 4, 5)).astype(np.float32),
              "bias": np.zeros(5, np.float32)},
        "big": rng.standard_normal(70_000).astype(np.float32),
        "ints": np.arange(300, dtype=np.int64),
        "flags": np.array([True, False]),
        "scalar": np.float32(2.5),
        "zero_d": np.array(7.0, np.float64),
        "empty": np.zeros((0, 4), np.float32),
        "bf16": np.asarray(jnp.asarray(rng.standard_normal((2, 3)),
                                       jnp.bfloat16)),
        **{f"k{i}": {"v": np.full(i + 1, i, np.float32)} for i in range(17)},
    }, "batch_stats": {}}
    want = serialization.to_bytes(tree)
    assert port("msgpack_dumps", tree) == want
    got = port("msgpack_loads", want)
    flat_want = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat_want:
        node = got
        for p in path:
            node = node[p.key]
        if leaf.dtype == jnp.bfloat16:
            values, dtype = node
            assert dtype == "torch.bfloat16"
            np.testing.assert_array_equal(values, leaf.astype(np.float32))
        else:
            assert np.asarray(node).dtype == leaf.dtype
            np.testing.assert_array_equal(node, leaf)
    assert got["batch_stats"] == {}


def test_bf16_export_loads_as_its_values(port, tmp_path):
    """A JAX export with bf16 leaves: the port's f32 parameters hold the
    bf16 values."""
    params, stats = _trees("fsrgan")
    to_bf16 = lambda t: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), t)
    path = str(tmp_path / "bf16.dgt")
    jck.export_generator(path, "fsrgan", 4, to_bf16(params), to_bf16(stats))
    as_f32 = lambda t: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a, np.float32), to_bf16(t))
    _, differ, dtype = port("load_matches_trees", path, as_f32(params),
                            as_f32(stats))
    assert differ == [] and dtype == "torch.float32"


def test_refusals(port, tmp_path, monkeypatch):
    params, stats = _trees("fsrgan")
    disc = str(tmp_path / "disc.dgt")
    jck.export_net(disc, "fsrgan", 4, params, stats, role="discriminator")
    assert "discriminator export, not a generator" in port("load_refusal",
                                                           disc)
    junk = tmp_path / "junk.dgt"
    junk.write_bytes(b"not an export at all")
    assert "is not a denoise_gan_tpu export" in port("load_refusal",
                                                     str(junk))
    # a truncated HDF5 file goes to the .h5 reader, which names the
    # structure it could not read
    h5 = tmp_path / "model.h5"
    h5.write_bytes(b"\x89HDF\r\n\x1a\n" + bytes(64))
    message = port("load_refusal", str(h5))
    assert "HDF5 structure" in message and "superblock" in message
    # flax chunks a leaf of MAX_CHUNK_SIZE bytes or more
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    chunked = str(tmp_path / "chunked.dgt")
    jck.export_generator(chunked, "fsrgan", 4, params, stats)
    assert "chunked array" in port("load_refusal", chunked)
    ok = str(tmp_path / "ok.dgt")
    monkeypatch.undo()
    jck.export_generator(ok, "fsrgan", 4, params, stats)
    assert "torch.cuda.is_available() is False" in port(
        "load_on_cuda_without_gpu", ok)
