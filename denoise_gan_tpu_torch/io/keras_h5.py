"""The reference's Keras ``.h5`` files read without h5py or TensorFlow
(denoise_gan_tpu/io/keras_h5.py).

The reference's whole checkpoint-to-inference contract is a Keras ``.h5``.
The JAX package reads one with h5py; the port reads it with its own HDF5
reader (io/hdf5.py), identifies the family, role and scale from the
weight stream, maps the Keras weights onto the Flax trees the JAX package
uses (``params``, ``batch_stats``) and fills the port's modules from them
(io/params.py::from_jax_params).  io/checkpoint.py::load_generator sends
an HDF5 file here, so ``infer_torch.py --model fsrgan.h5`` works as the
reference's ``infer.py`` does.

Weight layouts, as in the JAX module: Conv2D kernels (kh, kw, in, out)
are Flax's HWIO as they stand; DepthwiseConv2D (kh, kw, C, 1) becomes
(kh, kw, 1, C); Conv2DTranspose (kh, kw, out, in) becomes (kh, kw, in,
out) flipped in both spatial axes; BatchNormalization gamma, beta, moving
mean and variance become scale, bias, mean, var; a shared PReLU's (1, 1,
C) alpha becomes (C,).

The other way (tools/export_h5.py's, without TensorFlow or h5py):
``records_from_tree`` turns the Flax trees into the Keras-ordered weight
stream with the exact inverses of those transforms, and ``write_keras_h5``
lays the stream out as Keras' legacy full-model save does, by the graph's
description in ``keras_graphs/<graph>.json`` (its ``model_config``, layer
and weight names, and where each weight of the stream goes; written by
tests/make_keras_graphs.py from the reference graphs of tools/
bench_train_tf_cpu.py).  Seven graphs: the four generators at the JAX
tool's scales (SRGAN and FSRGAN 4, the others 1), the PatchGAN with logits
(SRGAN, FSRGAN) and with a sigmoid (the autoencoder), and pix2pix's
discriminator.

Left out: the JAX module's TensorFlow routes (``keras_weight_stream``,
``load_keras_model``, ``convert_keras_model``), which need a live Keras
model, and tools/convert_h5.py's fallback that rebuilds the graph in
TensorFlow for weights-only files without the legacy ``layer_names``
attribute: the machine with the card has no TensorFlow.

As a script it is the counterpart of tools/convert_h5.py's h5py route::

    python3 -m denoise_gan_tpu_torch.io.keras_h5 --h5 in.h5 \\
        [--family auto|fsrgan|srgan|autoencoder|pix2pix] \\
        [--role generator|discriminator] [--scale N] --out out.dgt

writing a ``.dgt`` export (io/checkpoint.py::export_net) that both
packages read.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from denoise_gan_tpu_torch.io import hdf5
from denoise_gan_tpu_torch.io.params import from_jax_params, to_jax_trees
from denoise_gan_tpu_torch.models import build_generator, build_models

FAMILIES = ("autoencoder", "pix2pix", "srgan", "fsrgan")
DEFAULT_SCALE = {"autoencoder": 1, "pix2pix": 1, "srgan": 4, "fsrgan": 4}
HDF5_MAGIC = hdf5.SIGNATURE
GRAPHS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "keras_graphs")
# Keras' legacy writer splits a name list whose numpy array passes this
# into <name>0, <name>1, ... (HDF5_OBJECT_HEADER_LIMIT)
KERAS_ATTR_LIMIT = 64512

Records = list[tuple[str, list[np.ndarray]]]


def is_hdf5(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(8) == HDF5_MAGIC
    except OSError:
        return False


# ---------------------------------------------------------------------------
# the typed weight stream, in layer (construction) order

_BN_LEAVES = ("gamma", "beta", "moving_mean", "moving_variance")


def _classify_weight_group(parent: str, leaves: list[str]) -> str | None:
    """The layer kind of a saved weight group: from the leaf names (gamma,
    alpha, kernel), with the innermost layer name telling depthwise from
    plain convs (Keras 3 names both variables 'kernel') and transposed
    from plain ones.  So the reference FSRGAN's own layer names
    (block_N_expand, expanded_conv_depthwise, *_BN) classify too."""
    base = parent.lower().rsplit("/", 1)[-1]
    if any(leaf in leaves for leaf in _BN_LEAVES):
        return "bn"
    if "alpha" in leaves:
        return "prelu"
    if "depthwise_kernel" in leaves or "depthwise" in base:
        return "dwconv"
    if "kernel" in leaves:
        return "convt" if "transpose" in base else "conv"
    return None


def _ordered_arrays(kind: str, pairs: list[tuple[str, np.ndarray]],
                    where: str) -> list[np.ndarray]:
    """A group's arrays in the kind's order: kernel[, bias] / gamma, beta,
    mean, var / alpha."""
    d = dict(pairs)
    if len(d) != len(pairs):
        raise ValueError(f"duplicate weight leaves in '{where}': "
                         f"{[leaf for leaf, _ in pairs]}")
    if kind == "bn":
        missing = [leaf for leaf in _BN_LEAVES if leaf not in d]
        if missing:
            raise ValueError(f"BN group '{where}' missing {missing}")
        return [d[leaf] for leaf in _BN_LEAVES]
    if kind == "prelu":
        return [d["alpha"]]
    kernel = d.get("depthwise_kernel", d.get("kernel"))
    return [kernel] + ([d["bias"]] if "bias" in d else [])


def _s(x) -> str:
    return x.decode() if isinstance(x, bytes) else str(x)


def attr_list(attrs: dict, name: str) -> list[str]:
    """A name list attribute as Keras' legacy reader takes it
    (load_attributes_from_hdf5_group): `name`, or the chunks `name`0,
    `name`1, ... that its writer split a long list into; [] where
    neither is."""
    if name in attrs:
        return [_s(n) for n in attrs[name]]
    out, i = [], 0
    while f"{name}{i}" in attrs:
        out += [_s(n) for n in attrs[f"{name}{i}"]]
        i += 1
    return out


def h5_weight_stream(path: str) -> Records:
    """[(kind, arrays)] of every weighted layer of a legacy Keras ``.h5``
    (full model or weights), in the file's ``layer_names`` order; kinds
    conv / dwconv / convt / bn / prelu.  Each layer's ``weight_names`` are
    full variable paths ('block_1_expand/kernel', Keras 2's
    'sequential/batch_normalization/gamma:0'); the weights are grouped by
    their parent path, so one h5 group holding several layers' weights
    (the reference pix2pix's nested Sequential stacks) and custom layer
    names both classify."""
    records = []
    with hdf5.File(path) as f:
        g = f["model_weights"] if "model_weights" in f else f
        if not {"layer_names", "layer_names0"} & set(g.attrs):
            raise ValueError(
                f"{path}: no legacy layer_names attr, not a Keras "
                "full-model/weights .h5 (a .weights.h5 needs the JAX "
                "package's tools/convert_h5.py, with TensorFlow)")
        for name in attr_list(g.attrs, "layer_names"):
            grp = g[name]
            wnames = attr_list(grp.attrs, "weight_names")
            if not wnames:
                continue
            order: list[str] = []
            groups: dict[str, list[tuple[str, np.ndarray]]] = {}
            for w in wnames:
                parent, _, leaf = w.rpartition("/")
                parent = parent or name
                leaf = leaf.split(":")[0]       # Keras 2 ':0' suffixes
                if parent not in groups:
                    groups[parent] = []
                    order.append(parent)
                groups[parent].append((leaf, np.asarray(grp[w])))
            for parent in order:
                leaves = [leaf for leaf, _ in groups[parent]]
                kind = _classify_weight_group(parent, leaves)
                if kind is None:
                    raise ValueError(
                        f"unclassifiable weighted layer '{parent}' "
                        f"(weights {leaves}) in {path}: not a reference "
                        "graph?")
                records.append(
                    (kind, _ordered_arrays(kind, groups[parent], parent)))
    return records


# ---------------------------------------------------------------------------
# each family's ordered (Flax path, kind) spec; BN entries fill batch_stats'
# mean and var too

def _inverted_residual(i: int) -> list[tuple[str, str]]:
    p = f"body/InvertedResidual_{i}"
    spec = []
    if i:
        spec += [(f"{p}/expand", "conv"), (f"{p}/BatchNorm_0", "bn")]
    spec += [(f"{p}/depthwise", "dwconv"),
             (f"{p}/BatchNorm_{1 if i else 0}", "bn"),
             (f"{p}/project", "conv"),
             (f"{p}/BatchNorm_{2 if i else 1}", "bn")]
    return spec


def _up_stages(n: int) -> list[tuple[str, str]]:
    spec = []
    for i in range(n):
        spec += [(f"tail/up{i + 1}/Conv_0", "conv"),
                 (f"tail/up{i + 1}/PReLU_0", "prelu")]
    return spec


def gen_spec(family: str, scale: int | None = None) -> list[tuple[str, str]]:
    scale = DEFAULT_SCALE[family] if scale is None else scale
    if family == "fsrgan":
        # two pixel-shuffle stages whatever the scale
        spec = [("body/Conv_0", "conv"), ("body/BatchNorm_0", "bn"),
                ("body/PReLU_0", "prelu")]
        for i in range(6):
            spec += _inverted_residual(i)
        spec += [("body/Conv_1", "conv"), ("body/BatchNorm_1", "bn")]
        spec += _up_stages(2)
        spec += [("tail/out_conv", "conv")]
        return spec
    if family == "srgan":
        # scale // 2 pixel-shuffle stages
        spec = [("body/Conv_0", "conv"), ("body/BatchNorm_0", "bn"),
                ("body/PReLU_0", "prelu")]
        for i in range(16):
            spec += [(f"body/Conv_{1 + 2 * i}", "conv"),
                     (f"body/BatchNorm_{1 + 2 * i}", "bn"),
                     (f"body/Conv_{2 + 2 * i}", "conv"),
                     (f"body/BatchNorm_{2 + 2 * i}", "bn")]
        spec += [("body/Conv_33", "conv"), ("body/BatchNorm_33", "bn")]
        spec += _up_stages(max(scale // 2, 1))
        spec += [("tail/out_conv", "conv")]
        return spec
    if family == "autoencoder":
        return [(f"Conv_{i}", "conv") for i in range(17)]
    if family == "pix2pix":
        spec = [("Downsample_0/Conv_0", "conv")]
        for i in range(1, 8):
            spec += [(f"Downsample_{i}/Conv_0", "conv"),
                     (f"Downsample_{i}/BatchNorm_0", "bn")]
        for i in range(7):
            spec += [(f"Upsample_{i}/ConvTranspose_0", "convt"),
                     (f"Upsample_{i}/BatchNorm_0", "bn")]
        spec += [("ConvTranspose_0", "convt")]
        return spec
    raise ValueError(family)


def disc_spec(family: str) -> list[tuple[str, str]]:
    if family == "pix2pix":
        return [("Conv_0", "conv"),
                ("Conv_1", "conv"), ("BatchNorm_0", "bn"),
                ("Conv_2", "conv"), ("BatchNorm_1", "bn"),
                ("Conv_3", "conv"), ("BatchNorm_2", "bn"),
                ("Conv_4", "conv")]
    # the PatchGAN that srgan, fsrgan and the autoencoder share
    spec = [("Conv_0", "conv")]
    for i in range(1, 8):
        spec += [(f"Conv_{i}", "conv"), (f"BatchNorm_{i - 1}", "bn")]
    spec += [("Conv_8", "conv")]
    return spec


def infer_family_role(records: Records) -> tuple[str, str, int]:
    """(family, role, scale) from the sequence of weight kinds alone (a
    full-model .h5 carries no family tag).  The generators' streams
    differ (dwconv only in FSRGAN, convt only in pix2pix, a bare conv
    stack in the autoencoder, SRGAN's 16-block run at any even scale);
    the discriminators are pix2pix's and the PatchGAN, which srgan, fsrgan
    and the autoencoder share and which reads as fsrgan's."""
    kinds = [k for k, _ in records]
    for family in FAMILIES:
        # SRGAN builds scale // 2 stages for any even scale; the common
        # scales first
        scales = ((4, 2, 6, 8, 10, 12, 14, 16) if family == "srgan"
                  else (DEFAULT_SCALE[family],))
        for scale in scales:
            if kinds == [k for _, k in gen_spec(family, scale)]:
                return family, "generator", scale
    if kinds == [k for _, k in disc_spec("pix2pix")]:
        return "pix2pix", "discriminator", 1
    if kinds == [k for _, k in disc_spec("fsrgan")]:
        return "fsrgan", "discriminator", 4
    raise ValueError(
        f"unrecognized .h5 layer stream (kinds={kinds[:12]}...): "
        "not one of the reference's generator/discriminator graphs; pass "
        "--family/--role explicitly")


# ---------------------------------------------------------------------------
# the Keras stream onto the Flax trees

def _set(tree: dict, path: str, leaf: str, value: np.ndarray) -> None:
    node = tree
    for key in path.split("/"):
        node = node.setdefault(key, {})
    node[leaf] = np.asarray(value, np.float32)


def map_weights(records: Records, spec: list[tuple[str, str]]
                ) -> tuple[dict, dict]:
    """The Keras weight stream zipped against a Flax path spec: (params,
    batch_stats) nested dicts of f32 numpy arrays."""
    kinds = [k for k, _ in records]
    want = [k for _, k in spec]
    if kinds != want:
        raise ValueError(
            "h5 layer stream does not match the family graph:\n"
            f"  h5:   {kinds}\n  want: {want}")
    params: dict = {}
    stats: dict = {}
    for (kind, w), (path, _) in zip(records, spec):
        if kind == "conv":
            _set(params, path, "kernel", w[0])
        elif kind == "dwconv":
            _set(params, path, "kernel", np.transpose(w[0], (0, 1, 3, 2)))
        elif kind == "convt":
            _set(params, path, "kernel",
                 np.transpose(w[0][::-1, ::-1], (0, 1, 3, 2)))
        elif kind == "bn":
            gamma, beta, mean, var = w
            _set(params, path, "scale", gamma)
            _set(params, path, "bias", beta)
            _set(stats, path, "mean", mean)
            _set(stats, path, "var", var)
        elif kind == "prelu":
            _set(params, path, "alpha", np.reshape(w[0], (-1,)))
        if kind in ("conv", "dwconv", "convt") and len(w) > 1:
            _set(params, path, "bias", w[1])
    return params, stats


# ---------------------------------------------------------------------------
# validation against the port's module, and the loaders

def _shapes(tree: dict, prefix: str = "") -> dict[str, tuple]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}"
        if isinstance(value, dict):
            out.update(_shapes(value, path))
        else:
            out[path] = tuple(np.shape(value))
    return out


def _tree_check(got: dict, template: dict, where: str) -> None:
    """The converted tree against the module's, path by path with the
    shapes; ValueError naming what is missing, extra or of another
    shape."""
    gmap, tmap = _shapes(got), _shapes(template)
    if gmap != tmap:
        missing = sorted(set(tmap) - set(gmap))
        extra = sorted(set(gmap) - set(tmap))
        wrong = sorted(k for k in set(gmap) & set(tmap) if gmap[k] != tmap[k])
        raise ValueError(
            f"{where}: converted tree != the port's module; "
            f"missing={missing[:6]} extra={extra[:6]} shape-mismatch="
            f"{[(k, gmap[k], tmap[k]) for k in wrong[:6]]}")


def convert_records(records: Records, family: str, role: str, scale: int,
                    net: torch.nn.Module) -> tuple[dict, dict]:
    """The typed weight stream -> (params, batch_stats) of the family's
    `role`, checked against the port's module `net` of that graph."""
    spec = (gen_spec(family, scale) if role == "generator"
            else disc_spec(family))
    params, stats = map_weights(records, spec)
    want_params, want_stats = to_jax_trees(net)
    _tree_check(params, want_params, f"{family}/{role} params")
    _tree_check(stats, want_stats, f"{family}/{role} batch_stats")
    return params, stats


def load_h5(path: str, family: str = "auto", role: str = "generator",
            scale: int = 0, device: torch.device | str = "cpu",
            dtype: torch.dtype | None = None, generator_only: bool = False
            ) -> tuple[dict, torch.nn.Module]:
    """(config, module in eval mode on `device`) from a reference ``.h5``:
    the family's generator (compute `dtype`) or discriminator, filled
    from the file.  `family` "auto" identifies family, role and scale from
    the weight stream (``infer_family_role``); else the given `role` and
    `scale` (0: the family's default) are taken.  With `generator_only` a
    discriminator's file raises ValueError."""
    records = h5_weight_stream(path)
    if family == "auto":
        family, role, scale = infer_family_role(records)
    if generator_only and role != "generator":
        raise ValueError(f"{path} holds a {family} {role}, not a generator")
    scale = scale or DEFAULT_SCALE[family]
    net = (build_generator(family, dtype=dtype, device=device, scale=scale)
           if role == "generator" else
           build_models(family, scale=scale).build_discriminator(device))
    params, stats = convert_records(records, family, role, scale, net)
    from_jax_params(net, params, stats)
    return {"family": family, "scale": scale, "format": 1, "role": role,
            "source": "keras_h5"}, net


def load_h5_generator(path: str, device: torch.device | str = "cuda",
                      dtype: torch.dtype | None = None
                      ) -> tuple[dict, torch.nn.Module]:
    """(config, generator in eval mode on `device`, compute `dtype`) from a
    reference ``.h5``: the contract of io/checkpoint.py::load_generator.
    The card unless the caller asks for the CPU.  A discriminator's file
    raises ValueError."""
    config, net = load_h5(path, device=device, dtype=dtype,
                          generator_only=True)
    print(f"converted Keras h5 -> {config['family']} generator (scale "
          f"{config['scale']}): {path}")
    return config, net


# ---------------------------------------------------------------------------
# the Flax trees onto a Keras .h5 (tools/export_h5.py's direction)

def _node(tree: dict, path: str) -> dict:
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _f32(leaf) -> np.ndarray:
    """A leaf as the float32 array Keras' set_weights stores (a bf16 leaf
    of io/flax_msgpack.py is a torch tensor)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.float().numpy()
    return np.asarray(leaf, np.float32)


def records_from_tree(params: dict, stats: dict, family: str, role: str,
                      scale: int) -> Records:
    """The Flax trees -> Keras-ordered [(kind, arrays)], by the exact
    inverses of map_weights' transforms (tools/export_h5.py:43-73): a
    depthwise kernel's last two axes swapped back, a transposed conv's
    kernel flipped in both spatial axes and its last two axes swapped, a
    PReLU alpha reshaped to (1, 1, C), a BatchNorm as gamma, beta, moving
    mean and variance."""
    spec = (gen_spec(family, scale) if role == "generator"
            else disc_spec(family))
    records = []
    for path, kind in spec:
        p = _node(params, path)
        if kind == "conv":
            w = [_f32(p["kernel"])]
        elif kind == "dwconv":
            w = [np.transpose(_f32(p["kernel"]), (0, 1, 3, 2))]
        elif kind == "convt":
            w = [np.transpose(_f32(p["kernel"]), (0, 1, 3, 2))[::-1, ::-1]]
        elif kind == "bn":
            s = _node(stats, path)
            w = [_f32(p["scale"]), _f32(p["bias"]), _f32(s["mean"]),
                 _f32(s["var"])]
        else:                                       # prelu
            w = [_f32(p["alpha"]).reshape(1, 1, -1)]
        if kind in ("conv", "dwconv", "convt") and "bias" in p:
            w.append(_f32(p["bias"]))
        records.append((kind, w))
    return records


def graph_name(family: str, role: str) -> str:
    """The reference graph that holds `family`'s `role`: a generator's
    own, or one of the three discriminators."""
    if role == "generator":
        return f"{family}_generator"
    if family == "pix2pix":
        return "pix2pix_discriminator"
    return ("patchgan_sigmoid_discriminator" if family == "autoencoder"
            else "patchgan_discriminator")


def load_graph(name: str) -> dict:
    """keras_graphs/<name>.json (tests/make_keras_graphs.py)."""
    with open(os.path.join(GRAPHS_DIR, f"{name}.json")) as f:
        return json.load(f)


def _names_attr(group: hdf5.NewGroup, name: str, names: list[str]) -> None:
    """A name list as Keras' legacy writer stores it
    (save_attributes_to_hdf5_group): variable-length ASCII strings (h5py's
    form of a list of bytes), a float64 [] when empty, and past
    KERAS_ATTR_LIMIT bytes as a numpy ``S<n>`` array, split evenly into
    `name`0, `name`1, ... of fixed-length strings."""
    data = np.asarray([n.encode("utf-8") for n in names])
    chunks = 1
    while any(c.nbytes > KERAS_ATTR_LIMIT
              for c in np.array_split(data, chunks)):
        chunks += 1
    if chunks > 1:
        for i, chunk in enumerate(np.array_split(data, chunks)):
            group.attrs[f"{name}{i}"] = chunk
    elif names:
        group.attrs[name] = hdf5.Strings(names, "ascii")
    else:
        group.attrs[name] = np.array([])


def write_keras_h5(path: str, records: Records, family: str, role: str,
                   scale: int) -> None:
    """Write the weight stream `records` of `family`'s `role` as the
    reference's Keras full-model ``.h5`` (legacy format): the root's
    ``keras_version``, ``backend`` and ``model_config`` (UTF-8), and under
    ``model_weights`` its ``layer_names``, ``backend`` and
    ``keras_version`` (ASCII), a group a layer with its ``weight_names``,
    and each weight as a float32 dataset at ``<layer>/<weight name>``, as
    ``model.save`` of tools/export_h5.py's graph writes them (the graph's
    description: keras_graphs/).  ValueError where the stream does not
    fit the graph, and for an SRGAN generator of another scale than 4: the
    JAX tool builds only the 4x graph (tools/export_h5.py:113)."""
    if (family, role) == ("srgan", "generator") and scale != 4:
        raise ValueError(
            f"an SRGAN generator of scale {scale}: the reference graph that "
            "tools/export_h5.py builds (build_srgan_generator()) is the 4x "
            f"one, which a scale-{scale} export's weights do not fit")
    graph = load_graph(graph_name(family, role))
    arrays = [a for _, ws in records for a in ws]
    want = sum(len(g["weights"]) for g in graph["groups"])
    if len(arrays) != want:
        raise ValueError(f"{family} {role}: {len(arrays)} weights for the "
                         f"{graph['graph']} graph's {want}")
    attrs = graph["attrs"]
    root = hdf5.NewGroup()
    root.attrs["keras_version"] = attrs["keras_version"]
    root.attrs["backend"] = attrs["backend"]
    root.attrs["model_config"] = json.dumps(attrs["model_config"])
    weights = root.create_group("model_weights")
    _names_attr(weights, "layer_names", graph["layer_names"])
    weights.attrs["backend"] = hdf5.Strings(attrs["backend"], "ascii")
    weights.attrs["keras_version"] = hdf5.Strings(attrs["keras_version"],
                                                  "ascii")
    for g in graph["groups"]:
        group = weights.create_group(g["name"])
        _names_attr(group, "weight_names", g["weight_names"])
        for name, shape, index in g["weights"]:
            a = arrays[index]
            if list(a.shape) != shape:
                raise ValueError(
                    f"{family} {role}: weight {index} has shape "
                    f"{tuple(a.shape)}, the graph's {g['name']}/{name} "
                    f"{tuple(shape)}")
            group[name] = np.ascontiguousarray(a, np.float32)
    hdf5.write(path, root)


def main(argv: list[str] | None = None) -> int:
    from denoise_gan_tpu_torch.io.checkpoint import export_net

    p = argparse.ArgumentParser(
        description="Convert a reference Keras .h5 to a .dgt export, "
                    "without h5py or TensorFlow")
    p.add_argument("--h5", required=True,
                   help="Keras .h5 (full model, or weights with the legacy "
                        "layer_names attribute)")
    p.add_argument("--family", default="auto", choices=("auto",) + FAMILIES)
    p.add_argument("--role", default="generator",
                   choices=["generator", "discriminator"])
    p.add_argument("--scale", type=int, default=0,
                   help="0 = family default (srgan/fsrgan 4, else 1)")
    p.add_argument("--out", default="", help="default: <h5 stem>.dgt")
    args = p.parse_args(argv)
    config, net = load_h5(args.h5, args.family, args.role, args.scale)
    family, role, scale = config["family"], config["role"], config["scale"]
    if args.family == "auto":
        print(f"identified: {family} {role} scale {scale}")
    out = args.out or os.path.splitext(args.h5)[0] + ".dgt"
    export_net(out, family, scale, net, role=role)
    n = sum(t.numel() for t in net.parameters())
    print(f"wrote {out} ({family} {role}, scale {scale}, {n:,} params)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
