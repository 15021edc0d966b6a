"""A ``.dgt`` export to the reference's Keras full-model ``.h5``
(tools/export_h5.py), without TensorFlow or h5py: a model trained on the
card runs with the reference's own infer.py / infer_video.py.

The export is read by io/checkpoint.py::read_export and io/flax_msgpack.py
(not Flax), its trees turned into the Keras-ordered weight stream by the
exact inverses of the loader's layout transforms
(io/keras_h5.py::records_from_tree), and the stream written as Keras'
legacy ``model.save`` of the reference graph writes it
(io/keras_h5.py::write_keras_h5, io/hdf5.py).  Generators and
discriminators, by the export's ``role``.  The flags and the output line
are the JAX tool's; it needs no device::

    python3 -m denoise_gan_tpu_torch.tools.export_h5 \\
        --dgt models/fsrgan_4x_50q.dgt [--out models/fsrgan_4x_50q.h5]
"""

from __future__ import annotations

import argparse
import os
import sys

from denoise_gan_tpu_torch.io import flax_msgpack, keras_h5
from denoise_gan_tpu_torch.io.checkpoint import read_export


def export_h5(dgt: str, out: str = "") -> tuple[str, dict]:
    """Write the ``.h5`` of the export `dgt` at `out` (default: <dgt
    stem>.h5); (its path, the export's config).  ValueError where the
    export does not fit the reference graph (an SRGAN of another scale
    than 4, say)."""
    config, payload = read_export(dgt)
    family, scale = config["family"], config["scale"]
    role = config.get("role", "generator")
    trees = flax_msgpack.loads(payload)
    records = keras_h5.records_from_tree(
        trees["params"], trees.get("batch_stats", {}), family, role, scale)
    out = out or os.path.splitext(dgt)[0] + ".h5"
    keras_h5.write_keras_h5(out, records, family, role, scale)
    return out, config


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="Export a repo `.dgt` artifact to a reference-consumable "
                    "Keras `.h5` (the reverse of tools/convert_h5.py)")
    p.add_argument("--dgt", required=True)
    p.add_argument("--out", default="", help="default: <dgt stem>.h5")
    args = p.parse_args(argv)
    out, config = export_h5(args.dgt, args.out)
    print(f"wrote {out} ({config['family']} "
          f"{config.get('role', 'generator')}, scale {config['scale']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
