#!/usr/bin/env python
"""Streaming video inference on the PyTorch port (denoise_gan_tpu_torch):
infer_video.py's flags, plus --device (cuda by default).  An .avi in the
uncompressed RGBA form is read and written without cv2."""

from denoise_gan_tpu_torch.infer.video import main

if __name__ == "__main__":
    main()
