"""The JAX side of the training tests (tests/test_torch_train_*.py): numpy
weights for Flax trees of shapes, the comparisons and their tolerances,
and the JAX package's whole train step as the oracle of the port's.

Tolerances (f32 on the CPU):
- losses: 1e-5 relative;
- gradients per tensor: cosine >= 0.9999 and max |d| <= 1e-3 max |g_JAX|.
  A tensor whose JAX gradient stays below 1e-5 of the net's largest is a
  bias that feeds a train-mode BatchNorm, whose gradient is zero in exact
  arithmetic (the BN takes out any per-channel constant): both sides must
  leave it below that level, and its direction, rounding noise, is not
  compared;
- new BN statistics: 1e-5 relative to each tensor's largest magnitude.
Adam's first update is about -lr sign(g), so the updated parameters say
little of the gradients; both optimizers' first moments after one step
are (1 - b1) g, so the step tests recover g from them.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
from flax import linen as nn

from denoise_gan_tpu.models import build_models
from denoise_gan_tpu.models.vgg import VGG19Features
from denoise_gan_tpu.train.state import GANTrainState, NetState, make_optimizers
from denoise_gan_tpu.train.step import build_train_step
from denoise_gan_tpu.utils.config import make_config

RTOL = 1e-5
COS = 0.9999
GRAD_ATOL = 1e-3
NOISE = 1e-5


def draw(tree, rng):
    """Numpy leaves for a Flax tree of shapes: glorot-scale (normal)
    kernels, small biases and BN means, BN scales in [0.8, 1.2], variances
    in [0.5, 1.5], PReLU slopes in [0.05, 0.3]: nothing at its init
    value, which would hide a mis-mapped leaf."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = draw(v, rng)
            continue
        shape = v.shape
        if k == "kernel":
            fans = np.prod(shape[:-1]) + np.prod(shape[:-2]) * shape[-1]
            a = rng.standard_normal(shape) * np.sqrt(2.0 / fans)
        elif k == "scale":
            a = rng.uniform(0.8, 1.2, shape)
        elif k == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif k == "alpha":
            a = rng.uniform(0.05, 0.3, shape)
        else:                                   # bias, mean
            a = rng.standard_normal(shape) * 0.05
        out[k] = np.asarray(a, np.float32)
    return out


def flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v, np.float32)


def assert_grads_close(got, want):
    """The gradient tolerance of the module docstring, per tensor."""
    got, want = dict(flat(got)), dict(flat(want))
    assert sorted(got) == sorted(want)
    largest = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        g = got[name]
        scale = np.abs(w).max()
        if scale <= NOISE * largest:
            assert np.abs(g).max() <= NOISE * largest, name
            continue
        cos = float((g * w).sum() / np.sqrt((g * g).sum() * (w * w).sum()))
        assert cos >= COS, (name, cos)
        assert np.abs(g - w).max() <= GRAD_ATOL * scale, name


def assert_trees_close(got, want, rtol=RTOL):
    """Per tensor within `rtol` of its largest magnitude: a running mean
    near 0 holds only the rounding of activations of order 1."""
    got, want = dict(flat(got)), dict(flat(want))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=rtol,
                                   atol=rtol * np.abs(w).max(), err_msg=name)


def vgg_tree(rng, size=32):
    """VGG19's tree with He-scale kernels (block5 stays away from 0)."""
    v = jax.eval_shape(lambda: VGG19Features().init(
        jax.random.key(0), jnp.zeros((1, size, size, 3))))
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * np.sqrt(
        2.0 / np.prod(s.shape[:-1])) if len(s.shape) == 4 else
        rng.standard_normal(s.shape) * 0.05).astype(np.float32), v["params"])


@contextlib.contextmanager
def dropout_masks():
    """Inside the block, every flax.linen.Dropout call of a traced
    program records its keep mask; the list yielded holds them in call
    order once the program has run (jax.debug.callback, the order fixed
    at trace time).  A kept value is x / 0.5, never 0 but where x is 0,
    whose mask bit changes nothing, so the mask is read as out != 0."""
    found = {}
    masks = []

    def record(index, keep):
        found[index] = np.asarray(keep)

    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, nn.Dropout) and \
                context.method_name == "__call__":
            jax.debug.callback(functools.partial(record, len(found)),
                               out != 0)
            found[len(found)] = None
        return out

    with nn.intercept_methods(intercept):
        yield masks
    masks.extend(found[i] for i in sorted(found))


def step_inputs(family: str, crop: int, batch: int, seed: int = 0) -> dict:
    """step_case's inputs, drawn from `seed` without running a step: gen
    and disc (params, stats), vgg, img_in, img_tgt."""
    cfg = make_config(family, crop_size=crop, batch_size=batch)
    bundle = build_models(family, scale=cfg.scale)
    lr = crop // cfg.scale if bundle.upscales else crop
    x = jnp.zeros((1, lr, lr, 3))
    y = jnp.zeros((1, crop, crop, 3))
    gv = jax.eval_shape(lambda: bundle.generator.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, x,
        train=False))
    dv = jax.eval_shape(lambda: bundle.discriminator.init(
        jax.random.key(0), *((y, y) if bundle.conditional_disc else (y,)),
        train=False))
    rng = np.random.default_rng(seed)
    gen = (draw(gv["params"], rng), draw(gv.get("batch_stats", {}), rng))
    disc = (draw(dv["params"], rng), draw(dv["batch_stats"], rng))
    vgg = vgg_tree(rng)
    img_in = (rng.random((batch, lr, lr, 3)) * 2 - 1).astype(np.float32)
    img_tgt = np.clip(
        np.repeat(np.repeat(img_in, crop // lr, 1), crop // lr, 2)
        + rng.standard_normal((batch, crop, crop, 3)) * 0.1,
        -1, 1).astype(np.float32)
    return dict(gen=gen, disc=disc, vgg=vgg, img_in=img_in, img_tgt=img_tgt)


@functools.lru_cache(maxsize=None)
def step_case(family: str, crop: int, batch: int, seed: int = 0):
    """The JAX package's step (degrade=False, jitted, run once) on numpy
    weights and a numpy pair: a dict of the inputs (step_inputs), JAX's
    metrics, the gradients recovered from both Adam states, the new
    statistics and, for pix2pix, the dropout masks that Flax drew (main
    pass, identity pass), taken by intercepting flax.linen.Dropout."""
    cfg = make_config(family, crop_size=crop, batch_size=batch)
    bundle = build_models(family, scale=cfg.scale)
    inputs = step_inputs(family, crop, batch, seed)
    gen, disc, vgg = inputs["gen"], inputs["disc"], inputs["vgg"]
    img_in, img_tgt = inputs["img_in"], inputs["img_tgt"]

    gen_tx, disc_tx = make_optimizers(cfg, family)
    state = GANTrainState(
        gen=NetState(gen[0], gen[1], gen_tx.init(gen[0])),
        disc=NetState(disc[0], disc[1], disc_tx.init(disc[0])),
        step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))
    step = jax.jit(build_train_step(bundle, cfg, degrade=False))

    with dropout_masks() as masks:
        new, metrics = step(state, vgg, (img_in, img_tgt),
                            jax.random.key(seed + 1))
        jax.block_until_ready(metrics)
    b1 = 0.5 if family == "pix2pix" else 0.9
    out = {
        "inputs": inputs,
        "metrics": {k: float(v) for k, v in metrics.items()
                    if k != "gen_output"},
        "gen_grads": jax.tree.map(lambda m: np.asarray(m) / (1 - b1),
                                  new.gen.opt_state[0].mu),
        "disc_grads": jax.tree.map(lambda m: np.asarray(m) / (1 - b1),
                                   new.disc.opt_state[0].mu),
        "gen_stats": jax.tree.map(np.asarray, new.gen.batch_stats),
        "disc_stats": jax.tree.map(np.asarray, new.disc.batch_stats),
        "step": int(new.step),
        "masks": None,
    }
    if masks:
        out["masks"] = (masks[:3], masks[3:])
    return out


def grad_readings(got, want) -> dict:
    """Per tensor: (cosine, max |d| / max |g_JAX|, norm ratio) where the
    JAX gradient is above the noise level of assert_grads_close."""
    got, want = dict(flat(got)), dict(flat(want))
    largest = max(np.abs(w).max() for w in want.values())
    out = {}
    for name, w in want.items():
        g, scale = got[name], np.abs(want[name]).max()
        if scale <= NOISE * largest:
            continue
        norm = np.sqrt((g * g).sum() * (w * w).sum())
        out[name] = (float((g * w).sum() / norm),
                     float(np.abs(g - w).max() / scale),
                     float(np.sqrt((g * g).sum() / (w * w).sum())))
    return out


def check_step(port, family: str, crop: int, batch: int):
    """The port's step against step_case's: every metric, the step count,
    each optimizer's betas and eps, both nets' new statistics, and the
    gradients recovered from both Adam states (assert_grads_close);
    returns the JAX case and the port's result."""
    case = step_case(family, crop, batch)
    i = case["inputs"]
    got = port("train_step", family, crop, batch, i["gen"], i["disc"],
               i["vgg"], i["img_in"], i["img_tgt"], case["masks"])
    for k, w in case["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=RTOL,
                                   atol=1e-8, err_msg=k)
    assert got["step"] == case["step"] == 1
    b1 = 0.5 if family == "pix2pix" else 0.9
    for name in ("gen_opt", "disc_opt"):
        _, betas, eps = got[name]
        assert tuple(betas) == (b1, 0.999) and eps == 1e-7
    assert_trees_close(got["gen_stats"], case["gen_stats"])
    assert_trees_close(got["disc_stats"], case["disc_stats"])
    for net in ("gen_grads", "disc_grads"):
        assert_grads_close(got[net], case[net])
    return case, got


@functools.lru_cache(maxsize=None)
def pix2pix_passes_case(seed: int = 31) -> dict:
    """JAX's pix2pix generator passes of the step at crop 256, batch 1,
    jitted on numpy weights: the main pass on a random input (its new
    statistics kept), the identity pass on a random target (its update
    thrown away), each with Flax's own dropout draw (the masks taken by
    dropout_masks), the gradient of both L1 losses.  Also the inputs."""
    from denoise_gan_tpu.losses.gan import l1_loss
    from denoise_gan_tpu.models import pix2pix as jp2p
    rng = np.random.default_rng(seed)
    model = jp2p.Pix2PixGenerator()
    img_in, img_tgt = ((rng.random((1, 256, 256, 3)) * 2 - 1).astype(
        np.float32) for _ in range(2))
    v = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        img_in, train=False))
    params, stats = draw(v["params"], rng), draw(v["batch_stats"], rng)

    @jax.jit
    def oracle(p, key, x, t):
        main_key, ident_key = jax.random.split(key)

        def loss_fn(p):
            out, mut = model.apply({"params": p, "batch_stats": stats}, x,
                                   train=True, mutable=["batch_stats"],
                                   rngs={"dropout": main_key})
            ident, _ = model.apply({"params": p, "batch_stats": stats}, t,
                                   train=True, mutable=["batch_stats"],
                                   rngs={"dropout": ident_key})
            loss = l1_loss(t, out) + l1_loss(t, ident)
            return loss, (out, ident, mut["batch_stats"])
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    with dropout_masks() as masks:
        (loss, (out, ident, new_stats)), grads = oracle(
            params, jax.random.key(2), img_in, img_tgt)
        jax.block_until_ready(loss)
    return dict(loss=float(loss), out=np.asarray(out),
                ident=np.asarray(ident),
                stats=jax.tree.map(np.asarray, new_stats),
                grads=jax.tree.map(np.asarray, grads),
                masks=(masks[:3], masks[3:]),
                inputs=(params, stats, img_in, img_tgt))


def onednn_comparison(port) -> dict:
    """pix2pix's generator passes (pix2pix_passes_case) in the port under
    the step's precision context and with oneDNN's CPU convolutions (TF32
    off only): each one's largest max |d| / max |g_JAX| over the gradient
    tensors, and the tensor where oneDNN's is worst."""
    want = pix2pix_passes_case()
    out = {}
    for name, onednn in (("exact_f32", False), ("onednn", True)):
        got = port("pix2pix_passes", *want["inputs"], want["masks"],
                   onednn=onednn)
        readings = grad_readings(got["grads"], want["grads"])
        worst = max(readings.items(), key=lambda kv: kv[1][1])
        out[name] = worst[1][1]
        out[name + "_tensor"] = worst[0]
    return out


def f64_comparison(port, with_vgg: bool = False) -> dict:
    """Against the port's float64 evaluation at pix2pix's step inputs
    (crop 256, batch 1; torch_side_training.f64_readings), the largest
    max |d| / max |g_f64| over the tensors of the D half's gradient, in
    f32 by the port and by JAX ("port_d", "jax_d"), and with `with_vgg`
    of the content loss's gradient with respect to the generator's output
    ("port_v", "jax_v")."""
    from denoise_gan_tpu.losses.gan import content_loss, discriminator_loss
    case = step_case("pix2pix", 256, 1)
    i = case["inputs"]
    got = port("f64_readings", i["gen"], i["disc"], i["img_in"],
               i["img_tgt"], case["masks"][0],
               i["vgg"] if with_vgg else None)
    fake = got["fake"]
    params, stats = i["disc"]
    model = build_models("pix2pix").discriminator

    def loss_fn(p):
        real, mut = model.apply({"params": p, "batch_stats": stats},
                                i["img_in"], i["img_tgt"], train=True,
                                mutable=["batch_stats"])
        fk, _ = model.apply({"params": p, **mut}, i["img_in"], fake,
                            train=True, mutable=["batch_stats"])
        return discriminator_loss(real, fk, True)

    ref = dict(flat(got["f64"][0]))

    def rel(tree):
        t = dict(flat(tree))
        return max(float(np.abs(t[k] - ref[k]).max() / np.abs(ref[k]).max())
                   for k in ref)

    out = {"port_d": rel(got["f32"][0]),
           "jax_d": rel(jax.jit(jax.grad(loss_fn))(params))}
    if with_vgg:
        v64 = got["f64"][1]
        scale = np.abs(v64).max()
        jv = jax.jit(jax.grad(lambda o, v, t: content_loss(v, t, o)))(
            fake, i["vgg"], i["img_tgt"])
        out["port_v"] = float(np.abs(got["f32"][1] - v64).max() / scale)
        out["jax_v"] = float(np.abs(np.asarray(jv) - v64).max() / scale)
    return out


if __name__ == "__main__":
    # The readings of oneDNN's and of the step's precision on pix2pix's
    # generator passes, and of pix2pix's whole step at 256 against float64
    # (~2 min on 8 CPU cores): python tests/training_oracles.py
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")
    from torch_process import torch_process
    with torch_process("torch_side_training") as call:
        print("pix2pix's generator passes, max |d| / max |g_JAX|:",
              onednn_comparison(call))
        print("pix2pix's step at 256 against float64:",
              f64_comparison(call, with_vgg=True))
