#!/usr/bin/env python
"""Still-image inference on the PyTorch port (denoise_gan_tpu_torch):
infer.py's flags, plus --device (cuda by default)."""

from denoise_gan_tpu_torch.infer.image import main

if __name__ == "__main__":
    main()
