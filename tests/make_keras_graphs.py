"""Write denoise_gan_tpu_torch/io/keras_graphs/<graph>.json: what the
reference's Keras writes in a full-model ``.h5`` for each of its seven
graphs, apart from the weights' values.

tools/export_h5.py (the JAX package's) builds the Keras graph with
tools/bench_train_tf_cpu.py in a fresh process and saves it with
``model.save``.  This script does the same, one graph a process (so that
Keras' layer-name counters start from zero, as there), with each weight
set to its index in the JAX tool's assignment order (its
``set_keras_weights``: the graph's weighted leaf layers, nested
Sequentials flattened, each layer's ``get_weights()`` order), and reads the
saved file back with h5py.  Each JSON holds:

* ``attrs``: the root's ``keras_version`` and ``backend``, and
  ``model_config`` as parsed JSON (``json.dumps`` of it gives back
  Keras' string exactly: checked here);
* ``layer_names``: ``model_weights``' attribute, in order;
* ``groups``: every group under ``model_weights`` (the layers, and Keras
  3's ``top_level_model_weights``), each with its ``weight_names`` and,
  for each weight, its shape and its index in the assignment order.

The marshalled code of each ``Lambda`` in ``model_config`` names the file
that made it; this script rewrites that name to the repo-relative
``tools/bench_train_tf_cpu.py``.  io/keras_h5.py::write_keras_h5 lays the
port's weights out by these files, without TensorFlow.  Needs TensorFlow,
Keras and h5py:

    python tests/make_keras_graphs.py

No test runs this script; it is named so that pytest does not collect it.
"""

from __future__ import annotations

import codecs
import json
import marshal
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
OUT = os.path.join(REPO, "denoise_gan_tpu_torch", "io", "keras_graphs")
SOURCE = "tools/bench_train_tf_cpu.py"
# graph -> the call that builds it (tools/export_h5.py:113-121)
GRAPHS = {
    "fsrgan_generator": "build_fsrgan_generator()",
    "srgan_generator": "build_srgan_generator()",
    "autoencoder_generator": "build_autoencoder_generator()",
    "pix2pix_generator": "build_pix2pix_generator()",
    "patchgan_discriminator": "build_discriminator(sigmoid=False)",
    "patchgan_sigmoid_discriminator": "build_discriminator(sigmoid=True)",
    "pix2pix_discriminator": "build_pix2pix_discriminator()",
}


def walk_layers(container):
    """tools/export_h5.py's order (denoise_gan_tpu/io/keras_h5.py::
    _walk_layers): leaf layers depth first, nested containers flattened."""
    for layer in container.layers:
        if getattr(layer, "layers", None):
            yield from walk_layers(layer)
        else:
            yield layer


def relative_lambdas(config):
    """Rewrite, in place, the file name in each Lambda's marshalled code
    (Keras' func_dump) to SOURCE."""
    if isinstance(config, dict):
        if config.get("class_name") == "__lambda__":
            raw = codecs.decode(config["config"]["code"].encode("ascii"),
                                "base64")
            code = marshal.loads(raw).replace(co_filename=SOURCE)
            config["config"]["code"] = codecs.encode(
                marshal.dumps(code), "base64").decode("ascii")
        for value in config.values():
            relative_lambdas(value)
    elif isinstance(config, list):
        for value in config:
            relative_lambdas(value)


def one_graph(name: str) -> None:
    """Build, save and read back one graph; write its JSON."""
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "")
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import h5py
    import keras
    import numpy as np

    import bench_train_tf_cpu as ref

    model = eval(f"ref.{GRAPHS[name]}")
    index = 0
    for layer in walk_layers(model):
        weights = layer.get_weights()
        if not weights:
            continue
        layer.set_weights([np.full(w.shape, index + i, np.float32)
                           for i, w in enumerate(weights)])
        index += len(weights)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.h5")
        model.save(path)
        with h5py.File(path, "r") as f:
            text = f.attrs["model_config"]
            config = json.loads(text)
            assert json.dumps(config) == text, "model_config does not " \
                "round-trip through json"
            relative_lambdas(config)
            g = f["model_weights"]
            assert dict(g.attrs)["backend"] == f.attrs["backend"]
            assert dict(g.attrs)["keras_version"] == f.attrs["keras_version"]
            layer_names = [str(n) for n in g.attrs["layer_names"]]
            groups, seen = [], set()
            for group in layer_names + sorted(set(g) - set(layer_names)):
                wnames = [str(w) for w in g[group].attrs["weight_names"]]
                weights = []
                for w in wnames:
                    a = g[group][w][()]
                    assert a.dtype == np.float32 and a.size
                    assert (a == a.flat[0]).all()
                    weights.append([w, list(a.shape), int(a.flat[0])])
                    seen.add(int(a.flat[0]))
                groups.append({"name": group, "weight_names": wnames,
                               "weights": weights})
            assert seen == set(range(index)), (sorted(seen), index)
            data = {"graph": name, "built_by": f"{SOURCE}::{GRAPHS[name]}",
                    "writer": f"keras {keras.__version__}, h5py "
                              f"{h5py.__version__}",
                    "attrs": {"keras_version": f.attrs["keras_version"],
                              "backend": f.attrs["backend"],
                              "model_config": config},
                    "layer_names": layer_names, "groups": groups}
    with open(os.path.join(OUT, f"{name}.json"), "w") as out:
        json.dump(data, out)
        out.write("\n")
    print(f"wrote {name}.json ({len(layer_names)} layers, {index} weights)")


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    procs = [subprocess.Popen([sys.executable, __file__, name])
             for name in GRAPHS]
    return max(p.wait() for p in procs)


if __name__ == "__main__":
    sys.exit(one_graph(sys.argv[1]) if len(sys.argv) > 1 else main())
