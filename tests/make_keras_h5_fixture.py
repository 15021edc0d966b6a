"""Write tests/data/fsrgan_ref.h5 and its sidecar tests/data/fsrgan_ref.json.

The `.h5` is the reference FSRGAN generator graph at full width (gf 32,
tools/bench_train_tf_cpu.py::build_fsrgan_generator, the reference's own
layer names) saved by Keras itself (``model.save``, the legacy HDF5 form
the reference writes), with weights drawn from numpy (seed 17; BatchNorm
variances positive).  The sidecar lists each dataset of the file: its path,
shape and the sha256 of its float32 bytes (C order), read back with h5py.

The port reads the file without h5py or TensorFlow
(denoise_gan_tpu_torch/io/hdf5.py); the tests and chip_smoke.py hold what
it reads against the sidecar.  Needs TensorFlow, Keras and h5py:

    python tests/make_keras_h5_fixture.py

No test runs this script; it is named so that pytest does not collect it.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

os.environ.setdefault("CUDA_VISIBLE_DEVICES", "")
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import h5py  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
H5 = os.path.join(DATA, "fsrgan_ref.h5")
SIDECAR = os.path.join(DATA, "fsrgan_ref.json")
SEED = 17


def seeded_weights(model, rng: np.random.Generator) -> list[np.ndarray]:
    """A value for every weight of `model`: kernels and biases N(0, 0.1),
    BatchNorm gammas 1 + N(0, 0.1), betas and means N(0, 0.1), variances
    U(0.5, 1.5), PReLU slopes U(0, 0.3)."""
    out = []
    for w in model.weights:
        name = w.path if hasattr(w, "path") else w.name
        shape = tuple(w.shape)
        if "moving_variance" in name:
            v = rng.uniform(0.5, 1.5, shape)
        elif "gamma" in name:
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif "alpha" in name:
            v = rng.uniform(0.0, 0.3, shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        out.append(v.astype(np.float32))
    return out


def datasets(path: str) -> list[dict]:
    """Each dataset of the file, in h5py's visiting order: its path, shape
    and the sha256 of its float32 bytes."""
    out = []
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                a = np.ascontiguousarray(obj[()], np.float32)
                out.append({"path": name, "shape": list(a.shape),
                            "sha256": hashlib.sha256(a.tobytes())
                            .hexdigest()})
        f.visititems(visit)
    return out


def main() -> int:
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
    import keras
    import bench_train_tf_cpu as ref

    model = ref.build_fsrgan_generator()
    model.set_weights(seeded_weights(model, np.random.default_rng(SEED)))
    os.makedirs(DATA, exist_ok=True)
    if os.path.exists(H5):
        os.remove(H5)
    model.save(H5)
    entries = datasets(H5)
    with open(SIDECAR, "w") as f:
        json.dump({"file": os.path.basename(H5),
                   "writer": f"keras {keras.__version__}, h5py "
                             f"{h5py.__version__}",
                   "seed": SEED,
                   "parameters": int(model.count_params()),
                   "datasets": entries}, f, indent=1)
        f.write("\n")
    print(f"wrote {H5} ({os.path.getsize(H5):,} bytes, "
          f"{model.count_params():,} parameters, {len(entries)} datasets) "
          f"and {SIDECAR}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
