"""Natural-image training (tools/train_natural.py): train on overlapping
tiles of real photographs and textures, hold grace_hopper out entirely,
and score it with tools/eval_natural.py --photos hopper.  The images are
the package's own copies (assets/, see assets/CREDITS.md), read by the
port's codec (data/native.py), so the tool needs neither sklearn,
matplotlib nor the simulation packages they come from.

  build : 288^2 tiles and their horizontal flips, at stride 64 on china
          and flower and at each texture's own stride, into
          --data_root/train/photos/*.npy (the pipeline's format; the train
          crop is jittered inside each tile): 72 tiles without the
          textures, 456 with them
  train : train/loop.py::train (the autoencoder by default, 1x, q 10) on
          those tiles, exported as models/nat_<family>.dgt

The flags are the JAX tool's, with ``--device`` (the card unless ``cpu``
is asked for) in place of ``--platform``::

    python3 -m denoise_gan_tpu_torch.tools.train_natural build
    python3 -m denoise_gan_tpu_torch.tools.train_natural train
    python3 -m denoise_gan_tpu_torch.tools.eval_natural \\
        --model models/nat_autoencoder.dgt --photos hopper --qs 10,30,50
"""

from __future__ import annotations

import argparse
import os
import tempfile
from pathlib import Path
from typing import Iterator

import numpy as np

from denoise_gan_tpu_torch.data import native

ASSETS = Path(__file__).resolve().parents[1] / "assets"
TILE = 288
STRIDE = 64

TRAIN_PHOTOS = {
    "china": ASSETS / "photos" / "china.jpg",
    "flower": ASSETS / "photos" / "flower.jpg",
}
# grace_hopper is the held-out eval photo (eval_natural.py --photos hopper)

# Photographic textures (wood, stone, skin, grass, sky), each with its
# tile stride: the big 1024^2 ones coarser, so that no source dominates
# the corpus.
_TEX = ASSETS / "textures"
TRAIN_TEXTURES = {
    "tile1": (_TEX / "tile1.png", 112),
    "marble1": (_TEX / "marble1.png", 112),
    "wmarble": (_TEX / "white_marble_tile.png", 160),
    "wmarble2": (_TEX / "white_marble_tile2.png", 192),
    "wood1": (_TEX / "wood1.png", 192),
    "darkwood": (_TEX / "darkwood.png", 192),
    "marble": (_TEX / "marble.png", 112),
    "silver": (_TEX / "silverRaw.png", 112),
    "foil": (_TEX / "foil.png", 112),
    "handskin": (_TEX / "skin.png", 192),
    "dogskin": (_TEX / "skin_texture.png", 192),
    "grass": (_TEX / "OutdoorGrassFloorD.png", 112),
    "sky": (_TEX / "OutdoorSkybox2048.png", 256),
}


def load_rgb01(path: str | Path) -> np.ndarray:
    """An image file as float32 RGB in [0, 1] (H, W, 3), by the port's
    codec; a file it cannot read raises."""
    img = native.decode(str(path))
    if img is None:
        raise IOError(f"the image codec cannot read {path}")
    return np.asarray(img, np.float32) / 255.0


def sources(textures: bool = True) -> list[tuple[str, Path, int]]:
    """(name, path, stride) of each image the corpus is tiled from."""
    out = [(name, path, STRIDE) for name, path in TRAIN_PHOTOS.items()]
    if textures:
        out += [(name, path, stride)
                for name, (path, stride) in TRAIN_TEXTURES.items()]
    return out


def tiles(name: str, path: Path, stride: int
          ) -> Iterator[tuple[str, np.ndarray]]:
    """(file name, tile) of each TILE^2 tile of the image on a `stride`
    grid, each followed by its horizontal flip."""
    im = load_rgb01(path)
    h, w = im.shape[:2]
    for y in range(0, h - TILE + 1, stride):
        for x in range(0, w - TILE + 1, stride):
            t = im[y:y + TILE, x:x + TILE]
            for k, v in (("", t), ("f", t[:, ::-1])):
                yield f"{name}_{y}_{x}{k}.npy", np.ascontiguousarray(v)


def build(args) -> None:
    out_dir = os.path.join(args.data_root, "train", "photos")
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for name, path, stride in sources(bool(args.textures)):
        for fname, tile in tiles(name, path, stride):
            np.save(os.path.join(out_dir, fname), tile)
            n += 1
    print(f"wrote {n} {TILE}^2 tiles to {out_dir}")


def train(args):
    from denoise_gan_tpu_torch.train.loop import train as train_loop
    from denoise_gan_tpu_torch.utils.config import make_config

    c = make_config(args.family,
                    image_dir=os.path.join(args.data_root, "train"),
                    device=args.device)
    c.crop_size = args.crop
    c.batch_size = args.batch
    c.scale = args.scale
    c.jpeg_quality = args.q
    n_tiles = len(os.listdir(
        os.path.join(args.data_root, "train", "photos")))
    spe = n_tiles // args.batch
    c.epochs = max(1, round(args.steps / spe))
    c.retrain = 0
    c.ckpt = 0
    c.log_images = 0
    c.save_iter = 10 ** 9
    c.model_name = f"nat_{args.family}"
    c.finalize()
    print(f"natural train: {args.family} tiles={n_tiles} spe={spe} "
          f"epochs={c.epochs} (~{c.epochs * spe} steps) q={args.q} "
          f"scale={args.scale}", flush=True)
    state = train_loop(c, args.family)
    print(f"export: models/{c.model_name}.dgt", flush=True)
    return state


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cmd", choices=["build", "train"])
    p.add_argument("--data_root",
                   default=os.path.join(tempfile.gettempdir(), "nat"))
    p.add_argument("--textures", type=int, default=1,
                   help="include the texture photos (0 = the two-photo "
                        "corpus)")
    p.add_argument("--family", default="autoencoder")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--crop", type=int, default=256,
                   help="train crop (the models are fully convolutional; "
                        "the eval stays at 256)")
    p.add_argument("--scale", type=int, default=1)
    p.add_argument("--q", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the card, the default), 'cuda:N' or 'cpu'")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "build":
        return build(args)
    return train(args)


if __name__ == "__main__":
    main()
