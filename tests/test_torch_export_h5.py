"""The port's reverse interop, a ``.dgt`` to the reference's Keras ``.h5``
without TensorFlow or h5py (denoise_gan_tpu_torch/tools/export_h5.py,
io/keras_h5.py's records_from_tree and write_keras_h5, io/hdf5.py's
writer), against h5py, Keras and the JAX repository's tools/export_h5.py;
and the engine profiler (tools/profile_engine.py) against the JAX tool's
parse_trace:

(a) io/hdf5.py's writer against h5py and the port's reader: f32, f64,
    f16, big-endian and i32 datasets, 0-d and 0-size; fixed-length and
    variable-length (UTF-8 and ASCII) string attributes, an empty
    weight_names; a group with enough links for several symbol-table
    nodes and a second B-tree level; a name list past Keras' limit split
    as Keras splits it.  Every value equal.
(b) Each of the seven reference graphs (the four generators, the
    PatchGAN with logits and with a sigmoid, pix2pix's discriminator):
    seeded numpy trees written as a .dgt by the JAX package's
    io/checkpoint.py::export_net, exported by the JAX tool (a subprocess,
    TensorFlow; its Flax template from jax.eval_shape, TOOL_LAUNCHER) and
    by the port's: in h5py's view the same groups,
    layer_names, weight_names, backend and keras_version, every dataset's
    dtype, shape and bytes, and model_config equal as parsed JSON but for
    each Lambda's marshalled code, whose file name the port's graph data
    make repo-relative (the code objects are compared apart).
(c) The Keras graphs of tools/bench_train_tf_cpu.py take load_weights of
    the port's FSRGAN (dwconv, PReLU) and pix2pix (convt) files: their
    forward within 1e-4 of the JAX package's Flax forward.
(d) The port's converter reads each port file back to trees bit-equal to
    the .dgt's.
(e) A scale-2 SRGAN export is refused.
(f) profile_engine.parse_trace prints the JAX tool's table for hand-made
    traces laid out where the JAX tool looks, with a device lane and
    without one.
(g) profile_engine's CLI on the CPU at a 27x120 frame exits 0 and prints
    its rows, with no JAX, h5py, TensorFlow, flax or Keras module loaded.

The port runs in two child processes (tests/torch_process.py), and the
JAX tool in one process a graph, all started by the module's first test
that needs them; the (b) tests come last, so that the JAX and Keras
forwards of (c) run while the JAX tool's processes do.
"""

import codecs
import contextlib
import functools
import gzip
import hashlib
import importlib.util
import io
import json
import marshal
import os
import struct
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_process import TIMEOUT_S, skip_without_torch, torch_process

skip_without_torch()

from denoise_gan_tpu.io import keras_h5 as jk  # noqa: E402
from denoise_gan_tpu.io.checkpoint import export_net  # noqa: E402
from denoise_gan_tpu.models import build_models  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
# pix2pix first: its JAX tool process is the slowest
GRAPHS = {"pix2pix": ("pix2pix", "generator", 1),
          "fsrgan": ("fsrgan", "generator", 4),
          "srgan": ("srgan", "generator", 4),
          "autoencoder": ("autoencoder", "generator", 1),
          "fsrgan-disc": ("fsrgan", "discriminator", 4),
          "autoencoder-disc": ("autoencoder", "discriminator", 1),
          "pix2pix-disc": ("pix2pix", "discriminator", 1)}
IN_SIZE = {"fsrgan": 24, "pix2pix": 256}
LAMBDA_SOURCE = "tools/bench_train_tf_cpu.py"
TOOL_S = 900          # one JAX tool process
# runs the JAX tool's main with its Flax template from jax.eval_shape: the
# same shapes as its eager init (from_bytes takes only the tree from it),
# without the init's seconds a family; the file written is byte for byte
# the same
TOOL_LAUNCHER = """
import runpy, sys
import jax
from denoise_gan_tpu.io import keras_h5 as jk
eager = jk._template_variables
jk._template_variables = lambda *a: jax.eval_shape(lambda: eager(*a))
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


@functools.lru_cache(maxsize=None)
def _template(family, role, scale):
    """The JAX package's Flax variables' shapes, from jax.eval_shape."""
    return jax.eval_shape(lambda: jk._template_variables(family, role,
                                                         scale))


def _draw(tree, rng):
    """Seeded leaves for a tree of shapes: glorot-scaled kernels,
    BatchNorm near identity (variances positive), PReLU slopes in [0.05,
    0.3]."""
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


def _digests(tree, prefix=""):
    """tests/torch_side_keras_h5.py::tree_digests."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_digests(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(np.shape(v)), hashlib.sha256(
                np.ascontiguousarray(v, np.float32).tobytes()).hexdigest())
    return out


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_export_h5", workers=2) as call:
        yield call


def _hand_trace(root, device: bool) -> str:
    """A Chrome trace under <root>/plugins/profile/x/y.trace.json.gz: a
    device lane ('/device:GPU:0') beside a host lane, or two host lanes;
    31 event names (one past 90 characters) over 400 complete events,
    and begin/end, instant and metadata events that do not count."""
    rng = np.random.default_rng(23 + device)
    names = [f"kernel_{i:02d}" for i in range(30)] + [
        "void a_templated_kernel<" + "int, " * 30 + "float>(float const*)"]
    events = [{"ph": "M", "name": "process_name", "pid": 1,
               "args": {"name": "/device:GPU:0" if device else "worker"}},
              {"ph": "M", "name": "process_name", "pid": 2,
               "args": {"name": "python3"}},
              {"ph": "B", "name": "step", "pid": 2, "ts": 0},
              {"ph": "i", "name": "mark", "pid": 1, "ts": 3}]
    for i in range(400):
        events.append({"ph": "X", "pid": int(rng.integers(1, 3)), "tid": 0,
                       "name": names[int(rng.integers(len(names)))],
                       "ts": i * 10, "dur": float(rng.integers(1, 9000))})
    events.append({"ph": "E", "name": "step", "pid": 2, "ts": 5000})
    run = os.path.join(root, "plugins", "profile", "x")
    os.makedirs(run)
    with gzip.open(os.path.join(run, "y.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(root)


@pytest.fixture(scope="module")
def started(port, tmp_path_factory):
    """The .dgt files, the JAX tool's processes and the port's runs, all
    started at once: {"trees", "dgt", "jax", "port", futures}."""
    root = tmp_path_factory.mktemp("export_h5")
    rng = np.random.default_rng(19)
    trees, dgts, procs = {}, {}, {}
    jax_h5 = {g: str(root / f"jax_{g}.h5") for g in GRAPHS}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for g, (family, role, scale) in GRAPHS.items():
        v = _template(family, role, scale)
        trees[g] = (_draw(v["params"], rng),
                    _draw(v.get("batch_stats", {}), rng))
        dgts[g] = str(root / f"{g}.dgt")
        export_net(dgts[g], family, scale, *trees[g], role=role)
        procs[g] = subprocess.Popen(
            [sys.executable, "-c", TOOL_LAUNCHER,
             os.path.join(TOOLS, "export_h5.py"), "--dgt", dgts[g], "--out",
             jax_h5[g]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env)
    port_h5 = {g: str(root / f"port_{g}.h5") for g in GRAPHS}
    v = _template("srgan", "generator", 2)
    srgan2 = str(root / "srgan2.dgt")
    export_net(srgan2, "srgan", 2, _draw(v["params"], rng),
               _draw(v["batch_stats"], rng))
    traces = {d: _hand_trace(root / f"trace_{d}", d) for d in (True, False)}
    futures = {
        "export": port.submit("export_all", {g: (dgts[g], port_h5[g])
                                             for g in GRAPHS}),
        "profile": port.submit("profile_cpu", 27, 120, 2),
        "split": port.submit("split_names", str(root / "split.h5"), 1500),
        "refusal": port.submit("refusal", srgan2, str(root / "srgan2.h5")),
        "trace_texts": {d: port.submit("parse_trace_text", t, 6)
                        for d, t in traces.items()},
    }
    yield {"root": root, "trees": trees, "dgt": dgts, "jax": jax_h5,
           "port": port_h5, "procs": procs, "trace_dirs": traces,
           **futures}
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def exported(started, port):
    """The port's export of every graph, and its reading back."""
    res = started["export"].result(TIMEOUT_S)
    back = port.submit("read_back", started["port"])
    return res, back


@pytest.fixture(scope="module")
def jax_tool(started):
    """Each JAX tool process's exit code and output."""
    out = {}
    for g, p in started["procs"].items():
        log, _ = p.communicate(timeout=TOOL_S)
        out[g] = (p.returncode, log)
    return out


# ---------------------------------------------------------------------------
# (a) the writer

def _writer_tree():
    """A NewGroup tree of every case of (a), written by the port's writer
    in this process (io/hdf5.py imports numpy only)."""
    from denoise_gan_tpu_torch.io import hdf5
    rng = np.random.default_rng(5)
    root = hdf5.NewGroup()
    root.attrs["text"] = "a variable-length string, UTF-8: éè"
    root.attrs["ascii"] = hdf5.Strings("tensorflow", "ascii")
    root.attrs["names"] = hdf5.Strings(["conv2d", "", "p_re_lu_1"], "ascii")
    root.attrs["utf8s"] = hdf5.Strings(["α", "b"])
    root.attrs["fixed"] = np.array([b"ab", b"cde", b""])
    root.attrs["empty"] = np.array([])
    root.attrs["int"] = np.int64(-5)
    root.attrs["floats"] = rng.standard_normal(7).astype(np.float32)
    root.attrs["big_endian"] = np.array([1.5, -2.5], ">f8")
    root["f32"] = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    root["nested/deeper/f64"] = rng.standard_normal((2, 7))
    root["nested/f16"] = rng.standard_normal(9).astype(np.float16)
    root["nested/i32"] = rng.integers(-2**31, 2**31 - 1, (4, 3),
                                      dtype=np.int32)
    root["nested/u8"] = rng.integers(0, 255, 11, dtype=np.uint8)
    root["big_endian"] = rng.standard_normal((4, 5)).astype(">f4")
    root["scalar"] = np.float32(3.25)
    root["empty"] = np.zeros((0, 3), np.float32)
    layer = root.create_group("model_weights/add")
    layer.attrs["weight_names"] = np.array([])
    many = root.create_group("many")
    for i in range(300):
        many[f"d{i:04d}"] = np.full(2, i, np.int32)
    many.attrs["weight_names"] = hdf5.Strings(
        [f"many/d{i:04d}" for i in range(300)], "ascii")
    return root


def _h5py_value(v):
    if isinstance(v, np.ndarray):
        return (v.dtype.str, v.shape, [x for x in v.ravel().tolist()])
    if isinstance(v, np.generic):
        return (v.dtype.str, (), v.item())
    return v


def _h5py_tree(path):
    """{path: (kind, attrs, (dtype, shape, bytes) of a dataset)} in
    h5py's view."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            attrs = {k: _h5py_value(v) for k, v in obj.attrs.items()}
            if isinstance(obj, h5py.Dataset):
                a = obj[()]
                out[name] = ("dataset", attrs, (a.dtype.str, a.shape,
                                                a.tobytes()))
            else:
                out[name] = ("group", attrs, None)
        out["/"] = ("group", {k: _h5py_value(v) for k, v in
                              f.attrs.items()}, None)
        f.visititems(visit)
    return out


def _want_tree(root):
    """The same view of the NewGroup tree itself."""
    from denoise_gan_tpu_torch.io import hdf5

    def attr(v):
        if isinstance(v, str):
            return v
        if isinstance(v, hdf5.Strings):
            texts = [s.decode() for s in v.values]
            return texts[0] if v.scalar else ("|O", (len(texts),), texts)
        return _h5py_value(np.asarray(v) if not isinstance(v, np.generic)
                           else v)

    out = {}

    def walk(group, prefix):
        out[prefix or "/"] = ("group", {k: attr(v) for k, v in
                                        group.attrs.items()}, None)
        for name, child in group.links.items():
            p = f"{prefix}/{name}".lstrip("/")
            if isinstance(child, hdf5.NewGroup):
                walk(child, p)
            else:
                out[p] = ("dataset", {}, (child.dtype.str, child.shape,
                                          child.tobytes()))

    walk(root, "")
    return out


def test_writer_matches_h5py_and_reader(tmp_path):
    from denoise_gan_tpu_torch.io import hdf5
    root = _writer_tree()
    path = str(tmp_path / "w.h5")
    hdf5.write(path, root)
    got, want = _h5py_tree(path), _want_tree(root)
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key], want[key]
        assert g[0] == w[0] and g[2] == w[2], key
        assert sorted(g[1]) == sorted(w[1]), key
        for name in w[1]:
            assert g[1][name] == w[1][name], (key, name)
    # the port's reader: the same values
    f = hdf5.File(path)
    for key, (kind, attrs, data) in want.items():
        node = f if key == "/" else f[key]
        assert isinstance(node, hdf5.Group) == (kind == "group"), key
        assert sorted(node.attrs) == sorted(attrs), key
        for name in attrs:
            assert _h5py_value(node.attrs[name]) == got[key][1][name], (
                key, name)
        if kind == "dataset":
            a = node[()]
            assert (a.dtype.str, a.shape, a.tobytes()) == data, key


def test_writer_links_need_two_btree_levels(tmp_path):
    """300 links: 38 symbol-table nodes of 8 under a level-1 group B-tree
    (32 children a node); every one found by name, by h5py and the
    port's reader."""
    from denoise_gan_tpu_torch.io import hdf5
    path = str(tmp_path / "w.h5")
    hdf5.write(path, _writer_tree())
    data = open(path, "rb").read()
    with h5py.File(path, "r") as f:
        addr = h5py.h5o.get_info(f["many"].id).addr
        assert [int(f[f"many/d{i:04d}"][0]) for i in range(300)] == list(
            range(300))
    version, _, count, _, size = struct.unpack_from("<BBHII", data, addr)
    pos, stab = addr + 16, None
    for _ in range(count):
        t, n = struct.unpack_from("<HH", data, pos)
        if t == 0x11:
            stab = struct.unpack_from("<Q", data, pos + 8)[0]
        pos += 8 + n
    assert data[stab:stab + 4] == b"TREE" and data[stab + 5] == 1
    port = hdf5.File(path)
    assert [int(port[f"many/d{i:04d}"][()][0]) for i in range(300)] == \
        list(range(300))


def test_writer_splits_long_name_lists(started):
    """io/keras_h5.py's name list past Keras' 64,512 bytes: split evenly
    into layer_names0, 1, ... of fixed-length strings, as Keras'
    save_attributes_to_hdf5_group does; h5py and the port read the whole
    list back; an empty list is h5py's float64 []."""
    r = started["split"].result(TIMEOUT_S)
    assert r["keys"] == ["layer_names0", "layer_names1"]
    assert r["read"] == r["names"] and r["empty"] == []
    with h5py.File(str(started["root"] / "split.h5"), "r") as f:
        attrs = f["model_weights"].attrs
        got = [n.decode() for k in ("layer_names0", "layer_names1")
               for n in attrs[k]]
        assert attrs["layer_names0"].dtype == np.dtype(
            f"S{len(r['names'][0])}")
        assert got == r["names"]
        assert f["model_weights/g"].attrs["weight_names"].dtype == \
            np.float64


# ---------------------------------------------------------------------------
# (c) Keras loads the port's file

@pytest.mark.parametrize("graph", ["fsrgan", "pix2pix"])
def test_keras_load_weights_matches_flax(started, exported, graph):
    tf = pytest.importorskip("tensorflow")
    sys.path.insert(0, TOOLS)
    import bench_train_tf_cpu as ref
    family, _, scale = GRAPHS[graph]
    params, stats = started["trees"][graph]
    n = IN_SIZE[graph]
    x = np.random.default_rng(29).uniform(-1, 1, (1, n, n, 3)).astype(
        np.float32)
    gen = build_models(family, scale=scale).generator
    want = np.asarray(jax.jit(gen.apply, static_argnames=("train",))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=False))
    assert exported[0][graph][0] == 0
    model = {"fsrgan": ref.build_fsrgan_generator,
             "pix2pix": ref.build_pix2pix_generator}[graph]()
    model.load_weights(started["port"][graph])
    got = model(tf.constant(x), training=False).numpy()
    assert got.shape == want.shape and np.std(want) > 0.05
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# (d), (e)

@pytest.mark.parametrize("graph", list(GRAPHS))
def test_port_reads_its_export_back_bit_equal(started, exported, graph):
    """read_export of the port's .h5 (the port's converter, the family
    and role identified from the weight stream: the autoencoder's
    PatchGAN reads as FSRGAN's, the same weights) against the .dgt's
    seeded trees."""
    family, role, scale = GRAPHS[graph]
    config, params, stats = exported[1].result(TIMEOUT_S)[graph]
    assert (config["role"], config["source"]) == (role, "keras_h5")
    assert config["family"] == ("fsrgan" if graph == "autoencoder-disc"
                                else family)
    want_params, want_stats = started["trees"][graph]
    assert params == _digests(want_params)
    assert stats == _digests(want_stats)


def test_srgan_scale2_refused(started):
    msg = started["refusal"].result(TIMEOUT_S)
    assert msg is not None and "scale 2" in msg
    assert not os.path.exists(started["root"] / "srgan2.h5")


# ---------------------------------------------------------------------------
# (f), (g) the profiler

def _jax_parse_trace():
    spec = importlib.util.spec_from_file_location(
        "jax_profile_engine", os.path.join(TOOLS, "profile_engine.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.parse_trace


@pytest.mark.parametrize("device", [True, False],
                         ids=["device-lane", "no-device-lane"])
def test_parse_trace_prints_jax_table(started, device):
    parse = _jax_parse_trace()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        parse(started["trace_dirs"][device], 6)
    want = log.getvalue()
    lines = want.splitlines()
    assert len(lines) == 2 + 1 + 25 and "ms device total" in lines[1]
    assert started["trace_texts"][device].result(TIMEOUT_S) == want


def test_profile_engine_runs_on_cpu(started):
    r = started["profile"].result(TIMEOUT_S)
    assert r["rc"] == 0 and r["foreign"] == []
    lines = r["log"].splitlines()
    assert lines[0] == ("profile_engine: fsrgan w8a8 (plain body) at "
                        "27x120, 2 frames on cpu")
    head = [i for i, line in enumerate(lines) if "ms device total" in line]
    assert len(head) == 1 and "over 2 frames" in lines[head[0]]
    rows = lines[head[0] + 2:]
    assert len(rows) == 25
    for row in rows:
        ms, count, name = row.split(None, 2)
        assert float(ms) >= 0 and int(count) >= 1 and name


# ---------------------------------------------------------------------------
# (b) against the JAX tool

def _lambda_codes(config, out):
    """Pop each Lambda's marshalled code out of `config` (in place) into
    `out`."""
    if isinstance(config, dict):
        if config.get("class_name") == "__lambda__":
            out.append(config["config"].pop("code"))
        for value in config.values():
            _lambda_codes(value, out)
    elif isinstance(config, list):
        for value in config:
            _lambda_codes(value, out)


def _keras_view(path):
    """h5py's view of a Keras file, model_config parsed, its Lambdas'
    code apart: (tree, model_config, codes)."""
    tree = _h5py_tree(path)
    attrs = dict(tree["/"][1])
    config = json.loads(attrs.pop("model_config"))
    codes = []
    _lambda_codes(config, codes)
    tree["/"] = ("group", attrs, None)
    return tree, config, codes


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_export_matches_jax_tool(started, exported, jax_tool, graph):
    family, role, scale = GRAPHS[graph]
    rc, line = exported[0][graph]
    assert rc == 0 and line == (f"wrote {started['port'][graph]} "
                                f"({family} {role}, scale {scale})")
    jrc, log = jax_tool[graph]
    assert jrc == 0, log[-3000:]
    got, got_config, got_codes = _keras_view(started["port"][graph])
    want, want_config, want_codes = _keras_view(started["jax"][graph])
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key
    assert got["model_weights"][1]["layer_names"] == \
        want["model_weights"][1]["layer_names"]
    assert got_config == want_config
    # one depth_to_space Lambda an upsampling stage
    assert len(got_codes) == len(want_codes) == (
        2 if family in ("fsrgan", "srgan") and role == "generator" else 0)
    for g, w in zip(got_codes, want_codes):
        gc, wc = (marshal.loads(codecs.decode(c.encode("ascii"), "base64"))
                  for c in (g, w))
        assert gc.co_filename == LAMBDA_SOURCE
        assert gc == wc
