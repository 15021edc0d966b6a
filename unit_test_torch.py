#!/usr/bin/env python
"""The inference comparison run (unit_test.py) on the PyTorch port
(denoise_gan_tpu_torch), plus --device (cuda by default)."""

from denoise_gan_tpu_torch.unit_test import main

if __name__ == "__main__":
    main()
