"""Data parallelism over torch.distributed (denoise_gan_tpu/parallel/)."""
