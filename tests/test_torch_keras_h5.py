"""The port's Keras ``.h5`` loading (denoise_gan_tpu_torch/io/hdf5.py,
io/keras_h5.py, io/checkpoint.py) against h5py and the JAX package's
denoise_gan_tpu/io/keras_h5.py, without TensorFlow:

- the reader on tests/data/fsrgan_ref.h5 (the reference FSRGAN saved by
  Keras itself, tests/make_keras_h5_fixture.py) against h5py: every
  dataset bit for bit, every attribute equal, and each dataset's sha256
  equal to the sidecar's;
- files written here with h5py in both forms Keras writes: Keras 3's
  (variable-length strings, 'layer/kernel', under model_weights, an
  input layer with no weights) and Keras 2's (fixed-length bytes,
  'layer/kernel:0', pix2pix's nested Sequential groups, at the root, as a
  weights file), holding the four generators' and the two discriminators'
  weight streams (gen_spec / disc_spec order) with seeded values, and
  SRGAN's at scales 2 and 8: the port's h5_weight_stream equals the JAX
  one, infer_family_role agrees, the port's generators (to_jax_trees) and
  read_export's trees equal the JAX package's bit for bit, and one small
  forward a generator family matches the JAX apply (f32: FSRGAN and SRGAN
  1e-4 as tests/test_torch_fsrgan.py, the 1x families 1e-5 as
  tests/test_torch_models_1x.py);
- the reader on structures h5py writes: a group of 1,000 entries (a
  B-tree of depth >= 1), attributes past the header's first block
  (continuation messages), an empty weight_names, scalar, 0-size,
  compact, big-endian, float16 and string datasets; and its refusals of a
  file written with libver='latest' and of a chunked gzip dataset;
- the converter CLI's .dgt read by the JAX package's load_generator, and
  infer_torch.py's image CLI on the .h5 and on that .dgt, byte-equal, in a
  process that has not imported h5py, JAX, flax, TensorFlow or Keras.

The port runs in two child processes (tests/torch_process.py), started
before the JAX oracles; the JAX package's loads take their Flax templates
from jax.eval_shape (the same shapes as its eager init, which costs
seconds a family).
"""

import collections
import functools
import hashlib
import json
import os
import struct

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_process import TIMEOUT_S, skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.io import keras_h5 as jk  # noqa: E402
from denoise_gan_tpu.models import build_models  # noqa: E402
from serving_files import load_generator as jax_load_dgt  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURE = os.path.join(DATA, "fsrgan_ref.h5")
SIDECAR = os.path.join(DATA, "fsrgan_ref.json")
GRAPHS = {"fsrgan": ("generator", 4), "srgan": ("generator", 4),
          "autoencoder": ("generator", 1), "pix2pix": ("generator", 1),
          "fsrgan-disc": ("discriminator", 4),
          "pix2pix-disc": ("discriminator", 1),
          "srgan-2x": ("generator", 2), "srgan-8x": ("generator", 8)}
FORMS = ("keras3", "keras2")
# (form, graph) of the files written here; SRGAN's other scales in one form
FILES = [(form, g) for form in FORMS for g in list(GRAPHS)[:6]] + [
    ("keras3", "srgan-2x"), ("keras3", "srgan-8x")]
F32_ATOL = {"fsrgan": 1e-4, "srgan": 1e-4, "autoencoder": 1e-5,
            "pix2pix": 1e-5}
IN_SIZE = {"fsrgan": 12, "srgan": 10, "autoencoder": 32, "pix2pix": 256}
KERAS_NAMES = {"conv": "conv2d", "dwconv": "depthwise_conv2d",
               "convt": "conv2d_transpose", "bn": "batch_normalization",
               "prelu": "p_re_lu"}


def _family(graph):
    return graph.split("-")[0]


_eager_template = jk._template_variables


@functools.lru_cache(maxsize=None)
def _shape_template(family, role, scale):
    """jk._template_variables from jax.eval_shape: the same shapes."""
    return jax.eval_shape(lambda: _eager_template(family, role, scale))


def _template(graph):
    return _shape_template(_family(graph), *GRAPHS[graph])


def _draw(tree, rng):
    """Seeded leaves for a Flax tree of shapes: glorot-scaled kernels,
    BatchNorm near identity, PReLU slopes in [0.05, 0.3]."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _draw(v, rng)
            continue
        shape = v.shape
        if k == "kernel":
            fans = np.prod(shape[:-1]) + np.prod(shape[:-2]) * shape[-1]
            a = (rng.random(shape, np.float32) * 2 - 1) * np.float32(
                np.sqrt(6.0 / fans))
        elif k == "alpha":
            a = rng.uniform(0.05, 0.3, shape)
        elif k in ("scale", "var"):
            a = rng.uniform(0.8, 1.2, shape)
        else:
            a = rng.standard_normal(shape) * 0.05
        out[k] = np.asarray(a, np.float32)
    return out


def _node(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _keras_layers(graph, params, stats):
    """[(layer name, kind, spec path, [(leaf, Keras array)])] in the
    stream's order, named as Keras names layers of no name."""
    role, scale = GRAPHS[graph]
    spec = (jk.gen_spec(_family(graph), scale) if role == "generator"
            else jk.disc_spec(_family(graph)))
    seen = collections.Counter()
    out = []
    for path, kind in spec:
        base = KERAS_NAMES[kind]
        name = base if not seen[base] else f"{base}_{seen[base]}"
        seen[base] += 1
        node = _node(params, path)
        if kind == "bn":
            s = _node(stats, path)
            leaves = [("gamma", node["scale"]), ("beta", node["bias"]),
                      ("moving_mean", s["mean"]),
                      ("moving_variance", s["var"])]
        elif kind == "prelu":
            leaves = [("alpha", node["alpha"].reshape(1, 1, -1))]
        else:
            k = node["kernel"]
            if kind == "dwconv":
                k = np.transpose(k, (0, 1, 3, 2))
            elif kind == "convt":
                k = np.transpose(k, (0, 1, 3, 2))[::-1, ::-1]
            leaves = [("kernel", np.ascontiguousarray(k))]
            if "bias" in node:
                leaves.append(("bias", node["bias"]))
        out.append((name, kind, path, leaves))
    return out


def _write_keras3(path, layers):
    """Keras 3's legacy .h5: variable-length strings, 'layer/leaf', under
    model_weights, an input layer with an empty weight_names."""
    text = h5py.string_dtype()
    with h5py.File(path, "w") as f:
        f.attrs["keras_version"] = "3.13.1"
        g = f.create_group("model_weights")
        g.attrs["layer_names"] = np.array(
            ["input_layer"] + [n for n, *_ in layers], dtype=text)
        g.create_group("input_layer").attrs["weight_names"] = np.array([])
        for name, _, _, leaves in layers:
            grp = g.create_group(name)
            grp.attrs["weight_names"] = np.array(
                [f"{name}/{leaf}" for leaf, _ in leaves], dtype=text)
            for leaf, a in leaves:
                grp[f"{name}/{leaf}"] = a


def _write_keras2(path, layers):
    """Keras 2's weights .h5: fixed-length bytes, 'layer/leaf:0' (a
    depthwise kernel 'depthwise_kernel'), at the root; pix2pix's Down- and
    Upsample blocks as nested Sequential layers that hold their convs'
    and BatchNorms' weights."""
    groups = collections.OrderedDict()
    n_seq = 0
    for name, kind, spec_path, leaves in layers:
        block = spec_path.split("/")[0]
        if block.startswith(("Downsample", "Upsample")):
            if block not in groups:
                groups[block] = (f"sequential_{n_seq}" if n_seq
                                 else "sequential", [])
                n_seq += 1
            outer, weights = groups[block]
            prefix = f"{outer}/{name}"
        else:
            outer, weights = name, []
            groups[name] = (outer, weights)
            prefix = name
        for leaf, a in leaves:
            leaf = "depthwise_kernel" if kind == "dwconv" and \
                leaf == "kernel" else leaf
            weights.append((f"{prefix}/{leaf}:0", a))
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array(
            [outer.encode() for outer, _ in groups.values()])
        for outer, weights in groups.values():
            grp = f.create_group(outer)
            grp.attrs["weight_names"] = np.array(
                [w.encode() for w, _ in weights])
            for w, a in weights:
                grp[w] = a


def _write_structures(path):
    """The structure cases of the module docstring."""
    rng = np.random.default_rng(5)
    with h5py.File(path, "w") as f:
        g = f.create_group("many")
        for i in range(1000):
            g[f"d{i:04d}"] = np.full(2, i, np.float32)
        g.attrs["weight_names"] = np.array([])
        d = f.create_dataset("attrs", data=np.arange(3, dtype=np.int16))
        for i in range(120):
            d.attrs[f"a{i:03d}"] = rng.standard_normal(i % 9)
        d.attrs["text"] = "a variable-length string " * 40
        d.attrs["texts"] = np.array(["x", "", "yz"],
                                    dtype=h5py.string_dtype())
        d.attrs["fixed"] = np.array([b"ab", b"cde"], dtype="S4")
        d.attrs["int"] = np.int64(-5)
        d.attrs["big_endian"] = np.array([1.5, -2.5], ">f4")
        d.attrs["u8"] = np.array([1, 255], np.uint8)
        f["scalar"] = np.float32(3.25)
        f["empty"] = np.zeros((0, 3), np.float32)
        f["big_endian"] = rng.standard_normal((4, 5)).astype(">f8")
        f["half"] = rng.standard_normal(7).astype(np.float16)
        f["strings"] = np.array(["a", "bb"], dtype=h5py.string_dtype())
        f["fixed"] = np.array([b"abc", b"d"], dtype="S3")
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        h5py.h5d.create(f.id, b"compact", h5py.h5t.IEEE_F32LE,
                        h5py.h5s.create_simple((2, 3)), dcpl=dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL,
            np.arange(6, dtype=np.float32).reshape(2, 3))


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a, np.float32).tobytes()
                          ).hexdigest()


def _tree_digests(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_tree_digests(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(np.shape(v)), _digest(v))
    return out


def _portable(value):
    """tests/torch_side_keras_h5.py::portable."""
    if isinstance(value, (np.ndarray, np.generic)) and value.dtype != object:
        return (type(value).__name__, value.dtype.str, value.shape,
                value.tobytes())
    return value


def _h5py_tree(path):
    out = {}

    def walk(group, prefix):
        out[prefix or "/"] = ("group", {k: _portable(v) for k, v in
                                        group.attrs.items()})
        for name in group.keys():
            node, p = group[name], f"{prefix}/{name}"
            if isinstance(node, h5py.Group):
                walk(node, p)
            else:
                out[p] = ("dataset", {k: _portable(v) for k, v in
                                      node.attrs.items()},
                          _portable(node[()]))

    with h5py.File(path, "r") as f:
        walk(f, "")
    return out


def _same(a, b):
    """Equal values of the same type; arrays of the same dtype and shape,
    bit for bit."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        if not (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)):
            return False
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype == object:
            return [type(x) for x in a.ravel()] == [
                type(x) for x in b.ravel()] and list(a.ravel()) == list(
                    b.ravel())
        return a.tobytes() == b.tobytes()
    return type(a) is type(b) and a == b


def _assert_same_tree(got, want):
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path]
        assert g[0] == w[0], path
        assert list(g[1]) == list(w[1]), path
        for name in w[1]:
            assert _same(g[1][name], w[1][name]), (path, name)
        if w[0] == "dataset":
            assert _same(g[2], w[2]), path


def _header_messages(data, addr):
    """{type: offset of its body} of the messages of the version-1 object
    header at `addr`, continuation blocks followed."""
    version, _, count, _, size = struct.unpack_from("<BBHII", data, addr)
    assert version == 1
    found, seen, blocks = {}, 0, [(addr + 16, size)]
    while blocks and seen < count:
        pos, size = blocks.pop(0)
        end = pos + size
        while pos + 8 <= end and seen < count:
            t, n = struct.unpack_from("<HH", data, pos)
            if t == 0x10:
                blocks.append(struct.unpack_from("<QQ", data, pos + 8))
            found.setdefault(t, pos + 8)
            seen += 1
            pos += 8 + n
    return found


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_keras_h5", workers=2) as call:
        yield call


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The files of the module docstring: {(form, graph): (path, params,
    stats)}, the structure file, the refused files, and an image."""
    root = tmp_path_factory.mktemp("keras_h5")
    rng = np.random.default_rng(11)
    out = {}
    trees = {}
    for form, graph in FILES:
        if graph not in trees:
            v = _template(graph)
            trees[graph] = (_draw(v["params"], rng),
                            _draw(v.get("batch_stats", {}), rng))
        params, stats = trees[graph]
        path = str(root / f"{form}_{graph}.h5")
        layers = _keras_layers(graph, params, stats)
        (_write_keras3 if form == "keras3" else _write_keras2)(path, layers)
        out[(form, graph)] = (path, params, stats)
    structures = str(root / "structures.h5")
    _write_structures(structures)
    latest = str(root / "latest.h5")
    with h5py.File(latest, "w", libver="latest") as f:
        f["x"] = np.zeros(3, np.float32)
    chunked = str(root / "chunked.h5")
    with h5py.File(chunked, "w") as f:
        f.create_dataset("x", data=np.zeros((8, 8), np.float32),
                         chunks=(4, 4), compression="gzip")
    images = root / "images"
    images.mkdir()
    np.save(images / "im.npy", (rng.random((20, 28, 3)) * 255).astype(
        np.uint8))
    inputs = {}
    for _, graph in FILES:
        if GRAPHS[graph][0] == "generator":
            n = IN_SIZE[_family(graph)]
            inputs[graph] = (rng.random((1, n, n, 3)) * 2 - 1).astype(
                np.float32)
    return {"h5": out, "structures": structures, "refused": [latest,
                                                             chunked],
            "images": str(images), "root": root, "inputs": inputs}


def _generator_cases(files):
    """{path: input} of the generator files the port can build (SRGAN 2x
    and 4x, not 8x), and the fixture."""
    cases = {path: files["inputs"][graph]
             for (form, graph), (path, _, _) in files["h5"].items()
             if GRAPHS[graph][0] == "generator" and graph != "srgan-8x"}
    cases[FIXTURE] = files["inputs"]["fsrgan"]
    return cases


@pytest.fixture(scope="module")
def started(port, files):
    """The port's runs, started in the child at once: their futures."""
    root = files["root"]
    paths = [p for p, _, _ in files["h5"].values()]
    discs = [p for (_, g), (p, _, _) in files["h5"].items()
             if GRAPHS[g][0] == "discriminator"]
    return {
        "fixture": port.submit("read_tree", FIXTURE),
        "structures": port.submit("read_tree", files["structures"]),
        "refused": port.submit("refusals", files["refused"]),
        "streams": port.submit("streams", paths + [FIXTURE]),
        "exports": port.submit("read_exports", discs),
        **{name: port.submit("load_generators", {
            p: x for p, x in _generator_cases(files).items()
            if ("pix2pix" in p) == (name == "pix2pix")})
           for name in ("generators", "pix2pix")},
        "cli": port.submit("convert_and_infer", FIXTURE,
                           str(root / "converted.dgt"), files["images"],
                           str(root / "out_h5"), str(root / "out_dgt")),
    }


def _loaded(started, path):
    """The port's load_generators result for `path`."""
    return started["pix2pix" if "pix2pix" in path else "generators"].result(
        TIMEOUT_S)[path]


@pytest.fixture(scope="module")
def jax_side(started, files):
    """The JAX package's reading of every file (its templates from
    jax.eval_shape), run here while the port's runs go on."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jk, "_template_variables", _shape_template)
        streams, loads, exports = {}, {}, {}
        for path in [p for p, _, _ in files["h5"].values()] + [FIXTURE]:
            records = jk.h5_weight_stream(path)
            family, role, scale = jk.infer_family_role(records)
            streams[path] = {
                "kinds": [k for k, _ in records],
                "arrays": [[(a.shape, _digest(a)) for a in arrays]
                           for _, arrays in records],
                "role": (family, role, scale)}
            if role == "discriminator":
                exports[path] = (family, role, scale, jk.convert_records(
                    records, family, role, scale))
        for path in _generator_cases(files):
            loads[path] = jk.load_h5_generator(path)
    return {"streams": streams, "loads": loads, "exports": exports}


def test_reader_matches_h5py_on_keras_fixture(started):
    _assert_same_tree(started["fixture"].result(TIMEOUT_S),
                      _h5py_tree(FIXTURE))


def test_fixture_matches_sidecar(started):
    """Each dataset the port reads hashes as the sidecar says (the card
    checks the same, chip_smoke.py phase 4i)."""
    side = json.load(open(SIDECAR))
    tree = started["fixture"].result(TIMEOUT_S)
    datasets = {p[1:]: v[2] for p, v in tree.items() if v[0] == "dataset"}
    assert len(datasets) == len(side["datasets"]) == 123
    for d in side["datasets"]:
        _, dtype, shape, raw = datasets[d["path"]]
        assert dtype == "<f4" and list(shape) == d["shape"]
        assert hashlib.sha256(raw).hexdigest() == d["sha256"]


def test_reader_structures_match_h5py(started, files):
    path = files["structures"]
    _assert_same_tree(started["structures"].result(TIMEOUT_S),
                      _h5py_tree(path))
    data = open(path, "rb").read()
    with h5py.File(path, "r") as f:
        many = h5py.h5o.get_info(f["many"].id).addr
        attrs = h5py.h5o.get_info(f["attrs"].id).addr
    assert 0x10 in _header_messages(data, attrs)      # a continuation
    # the group's B-tree (its symbol-table message): its root's level
    btree = struct.unpack_from("<Q", data,
                               _header_messages(data, many)[0x11])[0]
    assert data[btree:btree + 4] == b"TREE" and data[btree + 5] >= 1


def test_reader_refusals(started):
    latest, chunked = started["refused"].result(TIMEOUT_S)
    assert latest is not None and "superblock version 3" in latest
    assert chunked is not None and (
        "filter pipeline" in chunked or "chunked" in chunked)


@pytest.mark.parametrize("form,graph", FILES + [("keras", "fixture")],
                         ids=[f"{f}-{g}" for f, g in FILES] + ["fixture"])
def test_weight_stream_matches_jax(started, jax_side, files, form, graph):
    path = FIXTURE if graph == "fixture" else files["h5"][(form, graph)][0]
    got = started["streams"].result(TIMEOUT_S)[path]
    want = jax_side["streams"][path]
    assert got["kinds"] == want["kinds"]
    assert got["arrays"] == want["arrays"]
    assert tuple(got["role"]) == tuple(want["role"])
    if graph != "fixture":
        role, scale = GRAPHS[graph]
        assert tuple(got["role"]) == (
            "fsrgan" if graph == "fsrgan-disc" else _family(graph), role,
            scale)


@pytest.mark.parametrize("form,graph", [
    (f, g) for f, g in FILES if GRAPHS[g][0] == "generator"
    and g != "srgan-8x"] + [("keras", "fixture")], ids=[
    f"{f}-{g}" for f, g in FILES if GRAPHS[g][0] == "generator"
    and g != "srgan-8x"] + ["fixture"])
def test_generator_trees_match_jax(started, jax_side, files, form, graph):
    """to_jax_trees of the port's load_generator on the .h5 against the
    JAX package's load_h5_generator, bit for bit (and, for the files
    written here, the seeded trees themselves)."""
    path = FIXTURE if graph == "fixture" else files["h5"][(form, graph)][0]
    config, params, stats, _ = _loaded(started, path)
    want_config, want_params, want_stats = jax_side["loads"][path]
    assert config == want_config
    assert params == _tree_digests(want_params)
    assert stats == _tree_digests(want_stats)
    if graph != "fixture":
        _, seeded_params, seeded_stats = files["h5"][(form, graph)]
        assert params == _tree_digests(seeded_params)
        assert stats == _tree_digests(seeded_stats)


@pytest.mark.parametrize("graph", ["fsrgan", "srgan", "autoencoder",
                                   "pix2pix", "fixture"])
def test_generator_forward_matches_jax(started, jax_side, files, graph):
    path = FIXTURE if graph == "fixture" else files["h5"][("keras3",
                                                           graph)][0]
    x = _generator_cases(files)[path]
    config, params, stats = jax_side["loads"][path]
    gen = build_models(config["family"], scale=config["scale"]).generator
    variables = {"params": params, "batch_stats": stats}
    want = np.asarray(jax.jit(gen.apply, static_argnames=("train",))(
        variables, jnp.asarray(x), train=False))
    got = _loaded(started, path)[3]
    assert got.shape == want.shape and np.std(want) > 0.05
    np.testing.assert_allclose(got, want, atol=F32_ATOL[config["family"]])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("graph", ["fsrgan-disc", "pix2pix-disc"])
def test_discriminator_read_export_matches_jax(started, jax_side, files,
                                               form, graph):
    """io/checkpoint.py::read_export of a discriminator's .h5: the role
    identified from the stream, the trees the JAX package's
    convert_records gives."""
    path = files["h5"][(form, graph)][0]
    config, params, stats = started["exports"].result(TIMEOUT_S)[path]
    family, role, scale, (want_params, want_stats) = \
        jax_side["exports"][path]
    assert (config["family"], config["role"], config["scale"]) == (
        family, role, scale) == (_family(graph), "discriminator",
                                 GRAPHS[graph][1])
    assert params == _tree_digests(want_params)
    assert stats == _tree_digests(want_stats)


def test_converter_dgt_read_by_jax(started, jax_side, files):
    """The port's converter CLI on the fixture writes a .dgt whose trees,
    read by the JAX package's load_generator, are the JAX .h5 load's."""
    r = started["cli"].result(TIMEOUT_S)
    assert r["rc"] == 0 and "identified: fsrgan generator scale 4" in \
        r["log"]
    config, params, stats = jax_load_dgt(str(files["root"] /
                                             "converted.dgt"))
    want_config, want_params, want_stats = jax_side["loads"][FIXTURE]
    assert (config["family"], config["scale"], config["role"]) == (
        want_config["family"], want_config["scale"], "generator")
    assert _tree_digests(params) == _tree_digests(want_params)
    assert _tree_digests(stats) == _tree_digests(want_stats)


def test_image_cli_h5_equals_dgt_without_foreign_imports(started, files):
    """infer_torch.py's CLI on the .h5 and on the converter's .dgt write
    the same bytes; the child then holds no h5py, JAX, flax, TensorFlow
    or Keras module."""
    r = started["cli"].result(TIMEOUT_S)
    assert r["foreign"] == []
    a = np.load(files["root"] / "out_h5" / "im.npy")
    b = np.load(files["root"] / "out_dgt" / "im.npy")
    assert a.shape == (80, 112, 3) and a.dtype == np.uint8 and a.std() > 1
    np.testing.assert_array_equal(a, b)
