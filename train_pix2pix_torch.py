#!/usr/bin/env python
"""The pix2pix trainer of the PyTorch port: the JAX trainer's flags and
defaults (train_pix2pix.py) plus --device (cuda, the card, by default; cpu
on request).

    python3 train_pix2pix_torch.py --image_dir <dir of class folders> [flags]
"""

from denoise_gan_tpu_torch.train import loop


def main(argv: list[str] | None = None):
    """Train from `argv` (None: the command line); returns the final
    train state."""
    return loop.main("pix2pix", argv)


if __name__ == "__main__":
    main()
