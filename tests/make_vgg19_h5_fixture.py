"""Write tests/data/vgg19_notop_narrow.h5 and its sidecar
tests/data/vgg19_notop_narrow.json.

The `.h5` has the layout of Keras' VGG19 notop weights file (the legacy
``save_weights`` form: a group per layer at the root, the weights one
group down as ``<layer>/<layer>/kernel:0`` and ``bias:0``, the root's
``layer_names`` and each group's ``weight_names`` attributes), at narrow
widths (WIDTHS) so that the file stays small, with weights drawn from
numpy (seed 19).  The sidecar lists each conv's kernel and bias shape and
the sha256 of its float32 bytes (C order).

denoise_gan_tpu_torch/tools/convert_vgg19.py reads the file without h5py
(io/hdf5.py); tests/test_torch_quality_tools.py holds what it converts
against tools/convert_vgg19.py, and chip_smoke.py against the sidecar.
Needs h5py:

    python tests/make_vgg19_h5_fixture.py

No test runs this script; it is named so that pytest does not collect it.
"""

from __future__ import annotations

import hashlib
import json
import os

import h5py
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
H5 = os.path.join(DATA, "vgg19_notop_narrow.h5")
SIDECAR = os.path.join(DATA, "vgg19_notop_narrow.json")
SEED = 19
# (block, conv) in order, and each conv's filters (VGG19's are 64-512)
CONVS = [(1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3), (3, 4),
         (4, 1), (4, 2), (4, 3), (4, 4), (5, 1), (5, 2), (5, 3), (5, 4)]
WIDTHS = [2, 2, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4]


def layer_names() -> list[str]:
    """Keras' VGG19(include_top=False) layers, in order."""
    names = ["input_1"]
    for block in range(1, 6):
        names += [f"block{block}_conv{c}" for b, c in CONVS if b == block]
        names.append(f"block{block}_pool")
    return names


def weights() -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """layer -> (HWIO kernel N(0, 2 / fan_in), bias N(0, 0.05)), f32."""
    rng = np.random.default_rng(SEED)
    out, cin = {}, 3
    for (block, conv), width in zip(CONVS, WIDTHS):
        k = rng.standard_normal((3, 3, cin, width)) * np.sqrt(2 / (9 * cin))
        b = rng.standard_normal(width) * 0.05
        out[f"block{block}_conv{conv}"] = (k.astype(np.float32),
                                           b.astype(np.float32))
        cin = width
    return out


def main() -> None:
    os.makedirs(DATA, exist_ok=True)
    w = weights()
    with h5py.File(H5, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n in
                                           layer_names()])
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.1.5"
        for name in layer_names():
            g = f.create_group(name)
            if name not in w:
                g.attrs["weight_names"] = np.array([], dtype="S1")
                continue
            g.attrs["weight_names"] = np.array(
                [f"{name}/kernel:0".encode(), f"{name}/bias:0".encode()])
            sub = g.create_group(name)
            sub.create_dataset("kernel:0", data=w[name][0])
            sub.create_dataset("bias:0", data=w[name][1])
    side = {name: {part: {"shape": list(a.shape),
                          "sha256": hashlib.sha256(
                              np.ascontiguousarray(a, np.float32).tobytes()
                          ).hexdigest()}
                   for part, a in zip(("kernel", "bias"), arrays)}
            for name, arrays in w.items()}
    with open(SIDECAR, "w") as f:
        json.dump(side, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {H5} ({os.path.getsize(H5)} bytes) and {SIDECAR}")


if __name__ == "__main__":
    main()
