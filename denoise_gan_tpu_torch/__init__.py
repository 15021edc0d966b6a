"""PyTorch + CUDA port of denoise_gan_tpu for NVIDIA Hopper GPUs.

Module paths mirror the JAX package (``denoise_gan_tpu``), which stays the
reference: ``models/fsrgan.py`` here is the counterpart of
``denoise_gan_tpu/models/fsrgan.py`` and so on.  The package imports torch
and never jax or flax.

Ported so far: FSRGAN and SRGAN 4x inference through the kernel engines
(``infer/kernel_engine.py``), whose fused tails and inverted residuals are
hand-written CUDA kernels (``csrc/``) with plain PyTorch twins (``ops/``);
the four generators (``models/``); the generic frame engine, overlap
tiling and the coarse-tail rewrite (``infer/engine.py``, ``infer/tile.py``,
``infer/fast.py``) in plain PyTorch; the serving entry points: ``.dgt``
exports read and written without flax (``io/``), the video, image and
comparison CLIs (``infer/video.py``, ``infer/image.py``, ``unit_test.py``)
with an uncompressed RGBA AVI that needs no cv2 (``io/avi.py``), and the
reference's Keras ``.h5`` files read and written without h5py or
TensorFlow (``io/hdf5.py``, ``io/keras_h5.py``, ``tools/export_h5.py``);
training
of the four families (``train/``: the joint G+D step, the trainers'
loop, checkpoints and exports; ``models/discriminators.py``,
``models/vgg.py``, ``losses/``, ``ops/jpeg.py``, ``data/``) in plain
PyTorch; the data-parallel and space axes over torch.distributed
(``parallel/``),
the native image codec (``data/native.py``); the quality tools and the
engine profiler (``tools/``); and the TPU probes' counterparts
(``probes/``).
"""
