"""The training's building blocks in the port against the JAX package, on
the CPU: train-mode BatchNorm (f32 and bf16: outputs, new statistics,
gradients) and dropout; the three discriminators in train and eval mode
with gradients, at even and odd sizes (lax's stride-2 SAME pads one more
after than before where the total is odd); VGG19's features and every
loss; the panels' image ops; the JPEG round trip and the degradation.
The port runs in a child process (tests/torch_process.py).

Weights are numpy draws for the Flax trees of jax.eval_shape (no eager
Flax init), carried across with from_jax_params; each JAX oracle is
jitted.  Tolerances (f32 unless marked):
- losses, features and f32 outputs: 1e-5 relative to the largest
  magnitude of the tensor;
- gradients per tensor: cosine >= 0.9999 and max |d| <= 1e-3 max |g_JAX|
  (tests/training_oracles.py::assert_grads_close; a bias that feeds a
  train-mode BN has no gradient in exact arithmetic, and both sides must
  leave it below 1e-5 of the net's largest);
- new BN statistics: 1e-5 relative (to the largest magnitude);
- bf16 outputs and input gradients: within one bf16 ulp (of the larger
  magnitude) on all but < 1e-3 of the values;
- JPEG: values more than 1e-4 apart on < 1e-3 of them, the share printed
  (a DCT coefficient on a rounding boundary can flip a whole step
  between two summation orders).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from torch_process import skip_without_torch, torch_process
from training_oracles import (
    RTOL, assert_grads_close, assert_trees_close, draw,
)

skip_without_torch()

from denoise_gan_tpu.data.degrade import degrade_pair  # noqa: E402
from denoise_gan_tpu.losses import gan as jlosses  # noqa: E402
from denoise_gan_tpu.models import discriminators as jdisc  # noqa: E402
from denoise_gan_tpu.models.layers import BatchNorm as JBN  # noqa: E402
from denoise_gan_tpu.models.vgg import (  # noqa: E402
    VGG19Features, content_features, preprocess,
)
from denoise_gan_tpu.ops import image as jimage  # noqa: E402
from denoise_gan_tpu.ops import jpeg as jjpeg  # noqa: E402

BF16_ULP_SHARE = 1e-3
JPEG_SHARE = 1e-3
JPEG_ATOL = 1e-4


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_training") as call:
        yield call


def assert_close(got, want, name=""):
    """Within RTOL of the tensor's largest magnitude."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=name)


def bf16_ulp_share(got, want):
    """Share of values more than one bf16 ulp apart (the ulp of the larger
    magnitude)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return float((np.abs(got - want) > ulp).mean())


# ---------------------------------------------------------------------------
# (a) BatchNorm

@pytest.mark.parametrize("dtype, momentum", [
    ("f32", 0.99), ("f32", 0.8), ("bf16", 0.99)])
def test_batchnorm_train_matches_flax(port, dtype, momentum):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((3, 7, 9, 16)) * 2 + 0.7).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    scale = rng.uniform(0.8, 1.2, 16).astype(np.float32)
    bias = (rng.standard_normal(16) * 0.1).astype(np.float32)
    mean = (rng.standard_normal(16) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else None
    bn = JBN(momentum=momentum, dtype=jdt)
    xj = jnp.asarray(x, jdt or jnp.float32)
    gyj = jnp.asarray(gy, jdt or jnp.float32)

    @jax.jit
    def oracle(xj, params):
        def f(a, p):
            return bn.apply({"params": p,
                             "batch_stats": {"mean": mean, "var": var}},
                            a, train=True, mutable=["batch_stats"])
        y, mut = f(xj, params)
        _, pull = jax.vjp(lambda a, p: f(a, p)[0], xj, params)
        gx, gp = pull(gyj)
        return y, mut["batch_stats"], gx, gp

    y, stats, gx, gp = oracle(xj, {"scale": scale, "bias": bias})
    got = port("batchnorm_train", x, scale, bias, mean, var, momentum,
               dtype, gy)
    y_p, mean_p, var_p, gx_p, gs_p, gb_p, ydt = got
    assert ydt == ("torch.bfloat16" if dtype == "bf16" else "torch.float32")
    assert_close(mean_p, stats["mean"])
    assert_close(var_p, stats["var"])
    y = np.asarray(y, np.float32)
    gx = np.asarray(gx, np.float32)
    if dtype == "f32":
        assert_close(y_p, y)
        assert_grads_close({"x": gx_p}, {"x": gx})
    else:
        share_y, share_g = bf16_ulp_share(y_p, y), bf16_ulp_share(gx_p, gx)
        print(f"bf16 BN: output > 1 ulp on {share_y:.2e}, dx on "
              f"{share_g:.2e}")
        assert share_y < BF16_ULP_SHARE and share_g < BF16_ULP_SHARE
    assert_grads_close({"scale": gs_p, "bias": gb_p},
                       {"scale": gp["scale"], "bias": gp["bias"]})


def test_batchnorm_frozen_stats(port):
    """batch_stats_frozen leaves the running statistics; without it they
    move."""
    x = np.random.default_rng(1).standard_normal((2, 3, 3, 4)).astype(
        np.float32)
    assert port("frozen_batchnorm", x) == (True, True)


def test_dropout_as_flax(port):
    """Kept values double and dropped ones are 0, from the caller's mask
    as flax.linen.Dropout(0.5) computes them; a seeded generator draws
    the same mask twice, about half kept; eval mode is the identity."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 6, 6)).astype(np.float32)
    keep = rng.random(x.shape) < 0.5
    want = np.asarray(nn.Dropout(0.5).apply(
        {}, x, deterministic=False,
        rngs={"dropout": jax.random.key(3)}))
    jkeep = want != 0
    masked, a, b, ev = port("dropout", x, jkeep, 5)
    np.testing.assert_array_equal(masked, want)
    np.testing.assert_array_equal(a, b)
    assert 0.4 < (a != 0).mean() < 0.6
    np.testing.assert_array_equal(a[a != 0], 2 * x[a != 0])
    np.testing.assert_array_equal(ev, x)
    m2, _, _, _ = port("dropout", x, keep, 5)
    np.testing.assert_array_equal(m2, np.where(keep, x / 0.5, 0))


# ---------------------------------------------------------------------------
# (b) the discriminators

DISCS = {
    "patch": (functools.partial(jdisc.PatchDiscriminator, df=32), 1),
    "patch_sigmoid": (functools.partial(jdisc.PatchDiscriminator, df=32,
                                        sigmoid_head=True), 1),
    "paper": (functools.partial(jdisc.SRGANPaperDiscriminator, df=8), 1),
    "conditional": (jdisc.ConditionalPatchDiscriminator, 2),
}
SIZES = {"patch": (32, 33), "patch_sigmoid": (32, 33), "paper": (64, 65),
         "conditional": (32, 33)}


@functools.lru_cache(maxsize=None)
def disc_case(kind, size):
    """Weights, inputs, an output cotangent and JAX's answers (one jitted
    oracle): the train-mode output, new statistics and gradient of
    sum(out * gy), and the eval-mode output."""
    cls, n_in = DISCS[kind]
    rng = np.random.default_rng(sum(map(ord, kind)) * 1000 + size)
    model = cls()
    x = [(rng.random((2, size, size + 6, 3)) * 2 - 1).astype(np.float32)
         for _ in range(n_in)]
    v = jax.eval_shape(lambda: model.init(jax.random.key(0), *x,
                                          train=False))
    params = draw(v["params"], rng)
    stats = draw(v["batch_stats"], rng)

    def f(p, *inputs):
        return model.apply({"params": p, "batch_stats": stats}, *inputs,
                           train=True, mutable=["batch_stats"])

    gy = rng.standard_normal(jax.eval_shape(f, params, *x)[0].shape).astype(
        np.float32)

    @jax.jit
    def oracle(p, *a):
        out, mut = f(p, *a)
        grads = jax.grad(lambda p: (f(p, *a)[0] * gy).sum())(p)
        ev = model.apply({"params": p, "batch_stats": stats}, *a,
                         train=False)
        return out, mut["batch_stats"], grads, ev

    return x, params, stats, gy, oracle(params, *x)


@pytest.mark.parametrize("size_index", [0, 1], ids=["even", "odd"])
@pytest.mark.parametrize("kind", list(DISCS))
def test_discriminator_train_matches_flax(port, kind, size_index):
    x, params, stats, gy, (out, new, grads, _) = disc_case(
        kind, SIZES[kind][size_index])
    got, new_stats, got_grads = port("disc_run", kind, params, stats, x, gy,
                                     True)
    assert got.shape == out.shape and got.dtype == np.float32
    assert_close(got, out)
    assert_trees_close(new_stats, new)
    assert_grads_close(got_grads, grads)


@pytest.mark.parametrize("size_index", [0, 1], ids=["even", "odd"])
@pytest.mark.parametrize("kind", list(DISCS))
def test_discriminator_eval_matches_flax(port, kind, size_index):
    x, params, stats, _, (*_, want) = disc_case(kind,
                                                SIZES[kind][size_index])
    got = port("disc_run", kind, params, stats, x, None, False)
    assert_close(got, want)


# ---------------------------------------------------------------------------
# (c) VGG features and the losses; the panels' image ops

def test_vgg_features_and_losses_match_jax(port):
    rng = np.random.default_rng(4)
    size = 32
    v = jax.eval_shape(lambda: VGG19Features().init(
        jax.random.key(0), jnp.zeros((1, size, size, 3))))
    # He-scale kernels keep block5's activations away from 0
    vgg = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * np.sqrt(
        2.0 / np.prod(s.shape[:-1])) if len(s.shape) == 4 else
        rng.standard_normal(s.shape) * 0.05).astype(np.float32), v["params"])
    target = (rng.random((2, size, size, 3)) * 2 - 1).astype(np.float32)
    output = np.clip(target + rng.standard_normal(target.shape) * 0.1,
                     -1, 1).astype(np.float32)
    logits = (rng.standard_normal((2, 4, 4, 1)) * 3).astype(np.float32)
    probs = (1 / (1 + np.exp(-logits))).astype(np.float32)
    probs[0, 0, 0, 0] = 0.0                    # the Keras clip
    labels = (rng.random(logits.shape) < 0.5).astype(np.float32)

    @jax.jit
    def oracle(vgg, t, o, lg, pr, lb):
        return {
            "preprocess": preprocess(t),
            "features": content_features(vgg, t),
            "content": jlosses.content_loss(vgg, t, o),
            "bce_logits": jlosses.bce_logits(lb, lg),
            "bce_probs": jlosses.bce_probs(lb, pr),
            "adv_logits": jlosses.adversarial_loss(lg, True),
            "adv_probs": jlosses.adversarial_loss(pr, False),
            "disc_logits": jlosses.discriminator_loss(lg, -lg, True),
            "disc_half": jlosses.discriminator_loss(lg, -lg, True,
                                                    half=True),
            "disc_probs": jlosses.discriminator_loss(pr, 1 - pr, False),
            "l1": jlosses.l1_loss(t, o),
            "l2": jlosses.l2_loss(t, o),
            "tv": jlosses.tv_loss(t, o),
        }

    want = oracle(vgg, target, output, logits, probs, labels)
    got = port("vgg_and_losses", vgg, target, output, logits, probs, labels)
    assert sorted(got) == sorted(want)
    assert np.abs(np.asarray(want["features"])).mean() > 1e-2
    for k, w in want.items():
        assert_close(got[k], w, k)


@pytest.mark.parametrize("shape", [(2, 16, 24, 3), (1, 17, 9, 3)])
def test_image_ops_match_jax(port, shape):
    x = (np.random.default_rng(7).random(shape) * 2 - 1).astype(np.float32)
    got = port("image_ops", x)
    dx, dy = jimage.high_pass_x_y(x)
    want = {
        "total_variation": jimage.total_variation(x),
        "total_variation_map": jimage.total_variation_map(x),
        "dx": dx, "dy": dy,
        "renorm": jimage.renorm(x), "autoscale": jimage.autoscale(x),
        "to_uint8": jimage.to_uint8(x),
        "to_uint8_raw": jimage.to_uint8(x, norm=False),
        "sobel_edges": jimage.sobel_edges(x),
        "sobel_variation": jimage.sobel_variation(x),
        "laplacian": jimage.laplacian(x),
        "laplacian_hwc": jimage.laplacian(x[0]),
        "pixel_shuffle": jimage.pixel_shuffle(
            jnp.tile(x[..., :1], (1, 1, 1, 12)), 2),
    }
    assert ("im2patch" in got) == (shape[1] % 8 == 0 and shape[2] % 8 == 0)
    if "im2patch" in got:
        patches = jimage.im2patch(x[:1], 8)
        want["im2patch"] = patches
        want["patch2im"] = jimage.patch2im(patches, (shape[1] // 8,
                                                     shape[2] // 8))
        np.testing.assert_array_equal(want["patch2im"], x[:1])
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape, k
        if w.dtype == np.uint8:
            # a value at a truncation boundary may land one level apart
            assert np.abs(got[k].astype(int) - w).max() <= 1, k
            assert (got[k] != w).mean() < 1e-3, k
        else:
            assert_close(got[k], w, k)


# ---------------------------------------------------------------------------
# (d) JPEG and the degradation

def smooth_images(rng, n, h, w):
    """Colour waves plus noise in [0, 1]: block content like a photo's."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, (n, 1, 1, 3))
    img = 0.5 + 0.35 * np.sin(yy[None, ..., None] / 5.0 + phase
                              + xx[None, ..., None] / 7.0 * (1 + phase / 9))
    img = img + rng.standard_normal(img.shape) * 0.05
    return np.clip(img, 0, 1).astype(np.float32)


def jpeg_share(got, want):
    d = np.abs(got - np.asarray(want))
    return float((d > JPEG_ATOL).mean()), float(d.max())


@pytest.mark.parametrize("case", ["q10", "q50", "q90", "per_image",
                                  "no_subsample", "hwc"])
def test_jpeg_roundtrip_matches_jax(port, case):
    rng = np.random.default_rng(8)
    x = smooth_images(rng, 3, 40, 56)      # 40 x 56: padded to the MCU
    chroma = case != "no_subsample"
    if case == "per_image":
        quality = np.array([10.0, 50.0, 90.0], np.float32)
    elif case == "no_subsample":
        quality = 50
    elif case == "hwc":
        x, quality = x[0], 75
    else:
        quality = int(case[1:])
    want = jjpeg.jpeg_roundtrip(jnp.asarray(x), jnp.asarray(quality)
                                if np.ndim(quality) else quality,
                                chroma_subsample=chroma)
    got = port("jpeg", x, quality, chroma)
    assert got.shape == x.shape
    share, dmax = jpeg_share(got, want)
    print(f"jpeg {case}: > {JPEG_ATOL} apart on {share:.2e} (max {dmax:.2e})")
    assert share < JPEG_SHARE
    assert np.abs(np.asarray(want) - x).mean() > 1e-3      # not a no-op


def test_jpeg_tables_and_random_quality(port):
    q = np.array([1, 10, 49, 50, 51, 90, 100, 150], np.float32)
    luma, chroma = port("quality_tables", q)
    jl, jc = jjpeg.quality_to_tables(q)
    np.testing.assert_array_equal(luma, np.asarray(jl))
    np.testing.assert_array_equal(chroma, np.asarray(jc))
    a, b, shape = port("random_quality", 64, 3)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 25 and a.max() <= 75 and len(set(a)) > 10
    assert shape == (64, 16, 16, 3)


@pytest.mark.parametrize("scale", [1, 4])
def test_degrade_pair_matches_jax(port, scale):
    rng = np.random.default_rng(9)
    hr = smooth_images(rng, 2, 64, 96)
    q = np.array([30.0, 70.0], np.float32)
    want_in, want_tgt = jax.jit(degrade_pair, static_argnums=1)(
        jnp.asarray(hr), scale, jnp.asarray(q))
    got_in, got_tgt = port("degrade", hr, scale, q)
    assert got_in.shape == (2, 64 // scale, 96 // scale, 3)
    np.testing.assert_array_equal(got_tgt, np.asarray(want_tgt))
    share, dmax = jpeg_share(got_in, want_in)
    print(f"degrade x{scale}: > {JPEG_ATOL} apart on {share:.2e} "
          f"(max {dmax:.2e})")
    assert share < JPEG_SHARE
