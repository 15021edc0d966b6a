"""Convert pretrained VGG19 weights to the ``.npz`` that models/vgg.py
reads (tools/convert_vgg19.py): keys ``conv{block}_{idx}/kernel`` (HWIO)
and ``conv{block}_{idx}/bias``.

Sources:
  1. ``--h5``: a Keras ``vgg19_weights_tf_dim_ordering_tf_kernels_notop.h5``
     (layer groups at the root or under ``model_weights/``), read without
     h5py (io/hdf5.py);
  2. ``--torch``: a torchvision ``vgg19-*.pth`` state dict (its 4-D
     weights in layer order, OIHW -> HWIO; torchvision's VGG19 was trained
     on other preprocessing, so prefer the Keras file for parity with the
     reference's content loss).
The JAX tool's third source, a ``keras.applications`` download, needs
TensorFlow and the network and is not offered: without ``--h5`` or
``--torch`` the tool exits non-zero.  Usage::

    python3 -m denoise_gan_tpu_torch.tools.convert_vgg19 --h5 notop.h5 \\
        [--out models/vgg19_notop.npz]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# Keras layer names in order -> ours
KERAS_NAMES = [
    ("block1_conv1", "conv1_1"), ("block1_conv2", "conv1_2"),
    ("block2_conv1", "conv2_1"), ("block2_conv2", "conv2_2"),
    ("block3_conv1", "conv3_1"), ("block3_conv2", "conv3_2"),
    ("block3_conv3", "conv3_3"), ("block3_conv4", "conv3_4"),
    ("block4_conv1", "conv4_1"), ("block4_conv2", "conv4_2"),
    ("block4_conv3", "conv4_3"), ("block4_conv4", "conv4_4"),
    ("block5_conv1", "conv5_1"), ("block5_conv2", "conv5_2"),
    ("block5_conv3", "conv5_3"), ("block5_conv4", "conv5_4"),
]


def from_h5(path: str) -> dict[str, np.ndarray]:
    """Each layer's first dataset whose name holds ``kernel`` / ``bias``,
    directly in the layer's group or one group down (Keras 2 nests them
    as ``<layer>/<layer>/kernel:0``)."""
    from denoise_gan_tpu_torch.io.hdf5 import File

    out = {}
    with File(path) as f:
        for keras_name, ours in KERAS_NAMES:
            grp = (f[keras_name] if keras_name in f
                   else f["model_weights"][keras_name])

            def find(suffix):
                for k in grp.keys():
                    sub = grp[k]
                    if hasattr(sub, "keys"):
                        for kk in sub.keys():
                            if suffix in kk:
                                return np.asarray(sub[kk])
                    elif suffix in k:
                        return np.asarray(sub)
                raise KeyError(f"{keras_name}: no dataset matching {suffix}")

            out[f"{ours}/kernel"] = find("kernel")
            out[f"{ours}/bias"] = find("bias")
    return out


def from_torch(path: str) -> dict[str, np.ndarray]:
    """The state dict's 4-D ``*.weight`` tensors ordered by their module
    index (``features.<i>``), OIHW -> HWIO, with their biases."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    conv_keys = [k[:-7] for k in sd if k.endswith(".weight")
                 and sd[k].ndim == 4]
    conv_keys.sort(key=lambda k: int(k.split(".")[1]))
    out = {}
    for (_, ours), key in zip(KERAS_NAMES, conv_keys):
        w = sd[key + ".weight"].numpy()          # OIHW
        out[f"{ours}/kernel"] = np.transpose(w, (2, 3, 1, 0))  # -> HWIO
        out[f"{ours}/bias"] = sd[key + ".bias"].numpy()
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--h5", default="", help="Keras VGG19 notop .h5")
    p.add_argument("--torch", default="", help="torchvision vgg19 .pth")
    p.add_argument("--out", default="models/vgg19_notop.npz")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.h5:
        weights = from_h5(args.h5)
    elif args.torch:
        weights = from_torch(args.torch)
    else:
        print("no source given: pass --h5 (a Keras VGG19 notop .h5) or "
              "--torch (a torchvision vgg19 .pth); the keras.applications "
              "download needs TensorFlow and the network and is not "
              "offered", file=sys.stderr)
        return 2

    for (_, ours) in KERAS_NAMES:
        k = weights[f"{ours}/kernel"]
        assert k.ndim == 4 and k.shape[0] == 3 and k.shape[1] == 3, k.shape
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **weights)
    print(f"wrote {args.out} ({len(weights)} arrays)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
