"""The files the CLI tests of the port share (tests/test_torch_cli.py,
test_torch_cli_kernel.py, test_torch_image_cli.py): ``.dgt`` exports of
the JAX package's export_generator and RGBA AVIs of the port's writer.

Weights are drawn with numpy for the Flax tree shapes of jax.eval_shape:
kernels glorot-uniform (as tests/test_torch_fast.py draws them; at its
own He scale the autoencoder's bf16 output drifts, not a port fault,
which tests/test_torch_models_1x.py holds), biases and BN means small,
BN scales and variances and PReLU slopes away from 0 and 1.  Videos: 5
frames of smooth colour waves plus noise, a new scene at frame 3.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from denoise_gan_tpu.io import checkpoint as jck
from denoise_gan_tpu.models import autoencoder as jae
from denoise_gan_tpu.models import fsrgan as jfsrgan
from denoise_gan_tpu_torch.io import avi

FRAMES = 5
SIZES = {"autoencoder": (48, 64), "fsrgan": (100, 150)}
# family -> (scale, Flax generator, input size of the shape trace)
GENERATORS = {"autoencoder": (1, jae.AutoencoderGenerator(), 32),
              "fsrgan": (4, jfsrgan.FSRGANGenerator(), 16)}


@functools.lru_cache(maxsize=None)
def shapes(family):
    _, gen, size = GENERATORS[family]
    v = jax.eval_shape(lambda: gen.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((1, size, size, 3)), train=False))
    return v["params"], v.get("batch_stats", {})


def draw(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = draw(v, rng)
            continue
        shape = v.shape
        if k == "kernel":
            fans = np.prod(shape[:-1]) + np.prod(shape[:-2]) * shape[-1]
            a = rng.uniform(-1, 1, shape) * np.sqrt(6.0 / fans)
        elif k == "alpha":
            a = rng.uniform(0.05, 0.3, shape)
        elif k == "scale":
            a = rng.uniform(0.8, 1.2, shape)
        elif k == "var":
            a = rng.uniform(0.5, 1.5, shape)
        else:                                   # bias, mean
            a = rng.standard_normal(shape) * 0.05
        out[k] = np.asarray(a, np.float32)
    return out


def video_frames(h, w, seed):
    """BGR uint8 frames (see the module docstring)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / 9.0
    frames = []
    for i in range(FRAMES):
        if i in (0, 3):
            phase = rng.uniform(0, 2 * np.pi, 3)
        f = 0.5 + 0.35 * np.sin(yy[..., None] + xx[..., None] * 0.7 + phase
                                + 0.2 * i)
        f += 0.05 * rng.standard_normal((h, w, 3))
        frames.append((np.clip(f, 0, 1) * 255).astype(np.uint8))
    return frames


def write_files(root, families=tuple(GENERATORS)):
    """{family: (export path, video path)} under the directory `root`."""
    out = {}
    for family in families:
        seed = list(GENERATORS).index(family)
        scale = GENERATORS[family][0]
        rng = np.random.default_rng(seed)
        params, stats = (draw(t, rng) for t in shapes(family))
        model = str(root / f"{family}.dgt")
        jck.export_generator(model, family, scale, params, stats)
        h, w = SIZES[family]
        video = str(root / f"{family}.avi")
        vw = avi.VideoWriter(video, 12.0, (w, h))
        for f in video_frames(h, w, seed=10 + seed):
            vw.write(f)
        vw.release()
        out[family] = (model, video)
    return out


def load_generator(path):
    """The JAX package's load_generator without its eager Flax init: the
    same (config, params, batch_stats), through load_export_into with
    templates from jax.eval_shape (an eager init costs seconds;
    tests/test_torch_checkpoint.py holds load_generator itself)."""
    config, _ = jck.read_export(path)
    return jck.load_export_into(path, *shapes(config["family"]))


def envelope(what, got, want, bound):
    """u8 frames within bound = (max levels, share > 1 level, share > 0)."""
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"{what}: max {d.max()}, > 0 on {(d > 0).mean():.2e}, > 1 on "
          f"{(d > 1).mean():.2e}")
    assert d.max() <= bound[0] and (d > 1).mean() <= bound[1] and \
        (d > 0).mean() < bound[2]


def no_farther(what, got, want, ref):
    """The rule of tests/test_torch_models_1x.py for the autoencoder in
    bf16, whose bf16 roundings drift through 17 convs in both packages:
    the port's bf16 output `got` is no farther from the JAX package's f32
    output `ref` than JAX's bf16 output `want` is (max within one level
    more, share > 1 level within 1.25x + 1e-3)."""
    dj = np.abs(want.astype(np.int16) - ref.astype(np.int16))
    dp = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    print(f"{what} vs JAX f32: JAX bf16 max {dj.max()}, > 1 on "
          f"{(dj > 1).mean():.2e}, > 0 on {(dj > 0).mean():.2e}; port bf16 "
          f"max {dp.max()}, > 1 on {(dp > 1).mean():.2e}, > 0 on "
          f"{(dp > 0).mean():.2e}")
    assert dp.max() <= dj.max() + 1
    assert (dp > 1).mean() <= 1.25 * (dj > 1).mean() + 1e-3
