"""PyTorch + CUDA port of denoise_gan_tpu for NVIDIA Hopper GPUs.

Module paths mirror the JAX package (``denoise_gan_tpu``), which stays the
reference: ``models/fsrgan.py`` here is the counterpart of
``denoise_gan_tpu/models/fsrgan.py`` and so on.  The package imports torch
and never jax or flax.

Slice ported so far: FSRGAN 4x inference through the kernel engine
(``infer/kernel_engine.py``), whose fused tail is a hand-written CUDA kernel
(``csrc/tail.cu``) with a plain PyTorch twin (``ops/tail.py``).
"""
