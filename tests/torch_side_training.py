"""The PyTorch half of the training tests (tests/test_torch_train_*.py):
train-mode BatchNorm and dropout, the discriminators, VGG and the losses,
the image ops of the panels, JPEG and the degradation, the data pipeline,
the trainers' flags, the joint step and the trainer CLI of the port.

tests/torch_process.py runs these functions in a child process
(``torch_process("torch_side_training")``), so that no pytest worker
imports torch.  They take and return numpy arrays and plain Python values;
Flax trees travel as nested dicts of numpy arrays, gradients as Flax-layout
trees (io/params.py::to_jax_trees of a module holding them), bf16 tensors
as f32 arrays (which hold bf16 values exactly).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import os
import sys

import numpy as np
import torch

from denoise_gan_tpu_torch.data import pipeline as tpipeline
from denoise_gan_tpu_torch.data.degrade import degrade_pair
from denoise_gan_tpu_torch.io import checkpoint as tck
from denoise_gan_tpu_torch.io.params import from_jax_params, to_jax_trees
from denoise_gan_tpu_torch.losses import gan as tlosses
from denoise_gan_tpu_torch.models import build_models
from denoise_gan_tpu_torch.models import discriminators as tdisc
from denoise_gan_tpu_torch.models.layers import BatchNorm
from denoise_gan_tpu_torch.models.vgg import (
    VGG19Features, content_features, init_vgg_params, preprocess,
)
from denoise_gan_tpu_torch.ops import image as timage
from denoise_gan_tpu_torch.ops import jpeg as tjpeg
from denoise_gan_tpu_torch.train import loop as tloop
from denoise_gan_tpu_torch.train.state import create_train_state
from denoise_gan_tpu_torch.train.step import build_train_step
from denoise_gan_tpu_torch.utils import config as tconfig
from denoise_gan_tpu_torch.utils.device import exact_f32, no_tf32

DTYPES = {"f32": None, "bf16": torch.bfloat16}


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _t(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _grad_tree(model: torch.nn.Module, grads=None) -> dict:
    """The Flax-layout tree of `grads` (one tensor per parameter, in
    ``model.parameters()`` order; default: each parameter's .grad)."""
    if grads is None:
        grads = [p.grad for p in model.parameters()]
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for p, g in zip(holder.parameters(), grads):
            p.copy_(torch.zeros_like(p) if g is None else g)
    return to_jax_trees(holder)[0]


# ---------------------------------------------------------------------------
# models/layers.py: train-mode BatchNorm and Dropout

def batchnorm_train(x, scale, bias, mean, var, momentum, dtype, gy):
    """A train-mode BatchNorm on NHWC `x` (cast to `dtype`), its
    statistics given: (output, new mean, new var, d sum(y * gy) / dx,
    / dscale, / dbias)."""
    dt = DTYPES[dtype] or torch.float32
    bn = BatchNorm(x.shape[-1], momentum=momentum).train()
    bn.load_state_dict({"scale": _t(scale), "bias": _t(bias),
                        "mean": _t(mean), "var": _t(var)})
    xt = _t(x, dt).permute(0, 3, 1, 2).requires_grad_(True)
    y = bn(xt)
    (y.float() * _t(gy, dt).float().permute(0, 3, 1, 2)).sum().backward()
    return (_np(y.permute(0, 2, 3, 1)), _np(bn.mean), _np(bn.var),
            _np(xt.grad.permute(0, 2, 3, 1)), _np(bn.scale.grad),
            _np(bn.bias.grad), str(y.dtype))


def frozen_batchnorm(x):
    """Inside batch_stats_frozen the running statistics stay; outside they
    move: (unchanged inside, changed after)."""
    from denoise_gan_tpu_torch.models.layers import batch_stats_frozen
    bn = BatchNorm(x.shape[-1]).train()
    xt = _t(x).permute(0, 3, 1, 2)
    with batch_stats_frozen(bn):
        bn(xt)
    inside = bool((bn.mean == 0).all() and (bn.var == 1).all())
    bn(xt)
    return inside, bool((bn.mean != 0).any())


def dropout(x, keep, seed):
    """Dropout(0.5) in train mode on NCHW `x`: with the mask `keep`, twice
    from one seeded generator, and in eval mode."""
    from denoise_gan_tpu_torch.models.layers import Dropout
    d = Dropout(0.5).train()
    xt = _t(x)
    masked = d(xt, _t(keep))
    a = d(xt, torch.Generator().manual_seed(seed))
    b = d(xt, torch.Generator().manual_seed(seed))
    return _np(masked), _np(a), _np(b), _np(d.eval()(xt))


# ---------------------------------------------------------------------------
# models/discriminators.py

def _disc(kind, params, stats, dtype=None):
    dt = DTYPES[dtype] if dtype else None
    if kind == "patch":
        model = tdisc.PatchDiscriminator(32, False, dt)
    elif kind == "patch_sigmoid":
        model = tdisc.PatchDiscriminator(32, True, dt)
    elif kind == "paper":
        model = tdisc.SRGANPaperDiscriminator(8, dt)
    else:
        model = tdisc.ConditionalPatchDiscriminator(dt)
    return from_jax_params(model, params, stats)


def disc_run(kind, params, stats, inputs, gy, train):
    """`kind`'s discriminator on the NHWC `inputs` (one, or input and
    target): (output, new batch_stats tree, gradient tree of sum(out *
    gy)); eval mode returns the output alone."""
    model = _disc(kind, params, stats).train(train)
    out = model(*[_t(a) for a in inputs])
    if not train:
        return _np(out)
    (out * _t(gy)).sum().backward()
    return _np(out), to_jax_trees(model)[1], _grad_tree(model)


# ---------------------------------------------------------------------------
# models/vgg.py, losses/gan.py, ops/image.py

def vgg_and_losses(vgg_params, target, output, logits, probs, labels):
    """Every loss of losses/gan.py and the VGG features on the given
    arrays, as a dict of numpy values."""
    vgg = from_jax_params(VGG19Features(), vgg_params).eval()
    t, o = _t(target), _t(output)
    lg, pr, lb = _t(logits), _t(probs), _t(labels)
    with torch.no_grad():
        return {
            "preprocess": _np(preprocess(t)),
            "features": _np(content_features(vgg, t)),
            "content": _np(tlosses.content_loss(vgg, t, o)),
            "bce_logits": _np(tlosses.bce_logits(lb, lg)),
            "bce_probs": _np(tlosses.bce_probs(lb, pr)),
            "adv_logits": _np(tlosses.adversarial_loss(lg, True)),
            "adv_probs": _np(tlosses.adversarial_loss(pr, False)),
            "disc_logits": _np(tlosses.discriminator_loss(lg, -lg, True)),
            "disc_half": _np(tlosses.discriminator_loss(lg, -lg, True,
                                                        half=True)),
            "disc_probs": _np(tlosses.discriminator_loss(pr, 1 - pr,
                                                         False)),
            "l1": _np(tlosses.l1_loss(t, o)),
            "l2": _np(tlosses.l2_loss(t, o)),
            "tv": _np(tlosses.tv_loss(t, o)),
        }


def image_ops(x):
    """The panels' image ops and the patch helpers on NHWC `x` in [-1,
    1]."""
    t = _t(x)
    dx, dy = timage.high_pass_x_y(t)
    out = {
        "total_variation": _np(timage.total_variation(t)),
        "total_variation_map": _np(timage.total_variation_map(t)),
        "dx": _np(dx), "dy": _np(dy),
        "renorm": _np(timage.renorm(t)),
        "autoscale": _np(timage.autoscale(t)),
        "to_uint8": timage.to_uint8(t).numpy(),
        "to_uint8_raw": timage.to_uint8(t, norm=False).numpy(),
        "sobel_edges": _np(timage.sobel_edges(t)),
        "sobel_variation": _np(timage.sobel_variation(t)),
        "laplacian": _np(timage.laplacian(t)),
        "laplacian_hwc": _np(timage.laplacian(t[0])),
        "pixel_shuffle": _np(timage.pixel_shuffle(t[..., :1].repeat(
            1, 1, 1, 12), 2)),
    }
    if t.shape[1] % 8 == 0 and t.shape[2] % 8 == 0:
        patches = timage.im2patch(t[:1], 8)
        out["im2patch"] = _np(patches)
        out["patch2im"] = _np(timage.patch2im(
            patches, (t.shape[1] // 8, t.shape[2] // 8)))
    return out


# ---------------------------------------------------------------------------
# ops/jpeg.py, data/degrade.py

def jpeg(rgb01, quality, chroma_subsample=True):
    q = _t(np.asarray(quality, np.float32)) if np.ndim(quality) else quality
    return _np(tjpeg.jpeg_roundtrip(_t(rgb01), q, chroma_subsample))


def quality_tables(quality):
    return tuple(_np(t) for t in tjpeg.quality_to_tables(
        _t(np.asarray(quality, np.float32))))


def random_quality(n, seed):
    """Two draws of random_qualities from one seed, and one
    random_jpeg_quality batch's shape."""
    a = tjpeg.random_qualities(n, torch.Generator().manual_seed(seed))
    b = tjpeg.random_qualities(n, torch.Generator().manual_seed(seed))
    out = tjpeg.random_jpeg_quality(torch.rand(n, 16, 16, 3),
                                    torch.Generator().manual_seed(seed))
    return _np(a), _np(b), tuple(out.shape)


def degrade(hr01, scale, quality):
    q = _t(np.asarray(quality, np.float32)) if np.ndim(quality) else quality
    return tuple(_np(a) for a in degrade_pair(_t(hr01), scale, q))


# ---------------------------------------------------------------------------
# data/pipeline.py, utils/config.py

@contextlib.contextmanager
def _no_cv2():
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = None
    try:
        yield
    finally:
        if saved is None:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = saved


def pipeline_epochs(cfg_kwargs, epochs, seed=None):
    """The batches of `epochs` epochs of the port's DataPipeline, and its
    length."""
    cfg = tconfig.TrainConfig(**cfg_kwargs)
    p = tpipeline.DataPipeline(cfg, seed=seed)
    try:
        return len(p), [[b for b in p.epoch()] for _ in range(epochs)]
    finally:
        p.close()


def pipeline_error(cfg_kwargs):
    """The message of the exception a whole epoch raises, or None."""
    cfg = tconfig.TrainConfig(**cfg_kwargs)
    p = tpipeline.DataPipeline(cfg)
    try:
        for _ in p.epoch():
            pass
    except Exception as e:  # noqa: BLE001 -- returned to the test
        return f"{type(e).__name__}: {e}"
    finally:
        p.close()
    return None


def resize_up(img, crop, cv2):
    """_resize_up_if_needed with or without cv2."""
    if cv2:
        return tpipeline._resize_up_if_needed(img, crop)
    with _no_cv2():
        return tpipeline._resize_up_if_needed(img, crop)


def config_surface(trainer):
    """{flag: (default, type name)} of the trainer's parser."""
    parser = tconfig.build_parser(trainer)
    return {a.dest: (a.default, a.type.__name__) for a in parser._actions
            if a.dest != "help"}


def config_parsed(trainer, argv):
    return dataclasses.asdict(tconfig.parse_args(trainer, argv))


# ---------------------------------------------------------------------------
# train/state.py, train/step.py

def schedules(family, lr, counts):
    from denoise_gan_tpu_torch.train.state import ttur_schedules
    g, d = ttur_schedules(tconfig.make_config(family, lr=lr), family)
    return [g(c) for c in counts], [d(c) for c in counts]


def train_step(family, crop, batch_size, gen, disc, vgg_params, img_in,
               img_tgt, masks=None):
    """One port step with degrade=False on the CPU from the given Flax
    trees (gen, disc: (params, batch_stats)): (metrics, the gradients
    recovered from Adam's first moments (exp_avg / (1 - b1)) as Flax
    trees, the new batch_stats trees, the step count, each optimizer's
    rate and betas and eps)."""
    cfg = tconfig.make_config(family, crop_size=crop, batch_size=batch_size,
                              device="cpu")
    bundle = build_models(family, scale=cfg.scale)
    state = create_train_state(bundle, cfg, "cpu")
    from_jax_params(state.gen.model, *gen)
    from_jax_params(state.disc.model, *disc)
    vgg = from_jax_params(VGG19Features(), vgg_params).eval()
    vgg.requires_grad_(False)
    step = build_train_step(bundle, cfg, degrade=False)
    dropout = None
    if masks is not None:
        dropout = tuple([_t(m) for m in ms] for ms in masks)
    metrics = step(state, vgg, (_t(img_in), _t(img_tgt)), dropout=dropout)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "step": state.step}
    for name, net in (("gen", state.gen), ("disc", state.disc)):
        b1 = net.opt.param_groups[0]["betas"][0]
        grads = [net.opt.state[p]["exp_avg"] / (1 - b1)
                 for p in net.model.parameters()]
        out[name + "_grads"] = _grad_tree(net.model, grads)
        out[name + "_stats"] = to_jax_trees(net.model)[1]
        group = net.opt.param_groups[0]
        out[name + "_opt"] = (group["lr"], group["betas"], group["eps"])
    return out


def pix2pix_passes(params, stats, img_in, img_tgt, masks, onednn=False):
    """pix2pix's generator passes of the step in the port, train mode,
    under the step's precision context (exact_f32; with `onednn`, TF32
    off but oneDNN's CPU convolutions on): the main pass on `img_in` (its
    statistics kept), the identity pass on `img_tgt` under
    batch_stats_frozen, each with its three NHWC dropout masks; the
    gradient of l1(target, main) + l1(target, identity).  Returns loss,
    both outputs, the new stats tree and the gradient tree."""
    from denoise_gan_tpu_torch.models.layers import batch_stats_frozen
    gen = from_jax_params(build_models("pix2pix").build_generator_net(
        "cpu"), params, stats).train()
    tgt = _t(img_tgt)
    main = [_t(m) for m in masks[0]]
    ident_masks = [_t(m) for m in masks[1]]
    with (no_tf32() if onednn else exact_f32()):
        out = gen(_t(img_in), main)
        with batch_stats_frozen(gen):
            ident = gen(tgt, ident_masks)
        loss = tlosses.l1_loss(tgt, out) + tlosses.l1_loss(tgt, ident)
        loss.backward()
    return dict(loss=float(loss.detach()), out=_np(out), ident=_np(ident),
                stats=to_jax_trees(gen)[1], grads=_grad_tree(gen))


def disc_step_part(params, stats, img_in, img_tgt, fake):
    """The discriminator's half of pix2pix's step in the port: D(input,
    target) then D(input, fake) in train mode, their running statistics
    chaining, BCE from logits: (loss, new stats tree, gradient tree)."""
    model = _disc("conditional", params, stats).train()
    inp = _t(img_in)
    with exact_f32():
        loss = tlosses.discriminator_loss(model(inp, _t(img_tgt)),
                                          model(inp, _t(fake)), True)
        loss.backward()
    return float(loss), to_jax_trees(model)[1], _grad_tree(model)


def f64_readings(gen, disc, img_in, img_tgt, masks, vgg_params=None):
    """How far f32 gradients of pix2pix's step lie from the same functions
    in float64 at the step's own inputs, under the step's precision
    context (utils/device.py::exact_f32): the generator's output `fake`
    (train mode, the main pass's masks), then the discriminator's half
    (disc_step_part's loss) on it, and, with `vgg_params`, the content
    loss's gradient with respect to `fake`.  Returns fake and, per dtype,
    the D's gradient tree and the content gradient (or None)."""
    g = from_jax_params(build_models("pix2pix").build_generator_net(
        "cpu"), *gen).train()
    with torch.no_grad():
        fake = g(_t(img_in), [_t(m) for m in masks])
    out = {"fake": _np(fake)}
    for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
        with exact_f32():
            out[name] = _dtype_grads(fake, disc, img_in, img_tgt,
                                     vgg_params, dt)
    return out


def _dtype_grads(fake, disc, img_in, img_tgt, vgg_params, dt):
    """f64_readings' gradients in dtype `dt`."""
    d = _disc("conditional", *disc).to(dt).train()
    inp = _t(img_in).to(dt)
    real, fk = d(inp, _t(img_tgt).to(dt)), d(inp, fake.to(dt))
    # the BCE from logits, in the dtype (losses/gan.py reduces in f32)
    (torch.nn.functional.softplus(-real).mean()
     + torch.nn.functional.softplus(fk).mean()).backward()
    vgrad = None
    if vgg_params is not None:
        vgg = from_jax_params(VGG19Features(), vgg_params).to(dt).eval()
        vgg.requires_grad_(False)
        o = fake.detach().to(dt).clone().requires_grad_(True)
        t = content_features(vgg, _t(img_tgt).to(dt))
        ((t - content_features(vgg, o)) ** 2).mean().backward()
        vgrad = o.grad.double().numpy()
    return _grad_tree(d), vgrad


# ---------------------------------------------------------------------------
# train/loop.py and the trainer CLI

def _equal_states(a: dict, b: dict) -> list[str]:
    return sorted(k for k in a if not torch.equal(a[k].cpu(), b[k].cpu()))


def trainer_cli(workdir, argv, family="fsrgan"):
    """train_<family>_torch.py's main(argv) run in `workdir`, then: the
    final state's trees (gen, disc as (params, stats)); the names whose
    tensors differ between the exports read back into fresh nets and the
    final state; a fresh state restored from the last checkpoint against
    the final state (differing names, step, epoch); the checkpoint steps
    kept; the stdout."""
    old = os.getcwd()
    os.chdir(workdir)
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            state = tloop.main(family, argv)
        cfg = tconfig.parse_args(family, argv)
        bundle = build_models(family, scale=cfg.scale, fp16=bool(cfg.fp16))
        fresh = create_train_state(bundle, cfg, "cpu", seed=cfg.seed + 7)
        gen_cfg = tck.load_export_into(
            f"models/{cfg.model_name}.dgt", fresh.gen.model)
        disc_cfg = tck.load_export_into(
            f"models/{cfg.model_name}_disc.dgt", fresh.disc.model)
        export_diff = (
            _equal_states(fresh.gen.model.state_dict(),
                          state.gen.model.state_dict()),
            _equal_states(fresh.disc.model.state_dict(),
                          state.disc.model.state_dict()))
        restored = create_train_state(bundle, cfg, "cpu",
                                      seed=cfg.seed + 9)
        manager = tck.CheckpointManager(
            f"models/checkpoints/{cfg.model_name}", cfg.max_to_keep)
        manager.restore(restored)
        sd_a, sd_b = restored.state_dict(), state.state_dict()
        restore_diff = (
            _equal_states(sd_a["gen"], sd_b["gen"])
            + _equal_states(sd_a["disc"], sd_b["disc"]),
            repr(sd_a["gen_opt"]) == repr(sd_b["gen_opt"]),
            restored.step, restored.epoch, state.step, state.epoch)
        return {"gen": to_jax_trees(state.gen.model),
                "disc": to_jax_trees(state.disc.model),
                "configs": (gen_cfg, disc_cfg), "export_diff": export_diff,
                "restore": restore_diff, "kept": manager.steps(),
                "stdout": out.getvalue()}
    finally:
        os.chdir(old)


def warm_start(workdir, family, model_name, gen, disc):
    """warm_start_from_exports in `workdir` (its models/ holds the JAX
    package's exports): the names whose tensors differ from the given
    Flax trees."""
    old = os.getcwd()
    os.chdir(workdir)
    try:
        cfg = tconfig.make_config(family, device="cpu")
        bundle = build_models(family, scale=cfg.scale)
        state = create_train_state(bundle, cfg, "cpu")
        with contextlib.redirect_stdout(io.StringIO()):
            tloop.warm_start_from_exports(state, model_name)
        want_g = from_jax_params(copy.deepcopy(state.gen.model), *gen)
        want_d = from_jax_params(copy.deepcopy(state.disc.model), *disc)
        return (_equal_states(state.gen.model.state_dict(),
                              want_g.state_dict()),
                _equal_states(state.disc.model.state_dict(),
                              want_d.state_dict()))
    finally:
        os.chdir(old)


def trainer_refusal(argv, family="fsrgan"):
    """The (type, message) of main(argv)'s exception."""
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            tloop.main(family, argv)
    except (RuntimeError, ValueError) as e:
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_cuda.py)

def _hand_launches() -> int:
    from denoise_gan_tpu_torch.ops import mbconv, tail, tail_srgan
    return sum(sum(c.values()) for c in (tail.launch_counts,
                                         tail_srgan.launch_counts,
                                         mbconv.launch_counts))


def _recovered(state) -> dict:
    out = {}
    for name, net in (("gen", state.gen), ("disc", state.disc)):
        b1 = net.opt.param_groups[0]["betas"][0]
        out[name] = {n: (net.opt.state[p]["exp_avg"] / (1 - b1)).double()
                     .cpu() for n, p in net.model.named_parameters()}
    return out


def _grad_readings(got: dict, want: dict) -> tuple[float, float, float,
                                                   bool]:
    """(smallest cosine, largest |norm ratio - 1|, largest max|d| /
    max|g_want|, whether the tensors at the noise level (below 1e-5 of the
    net's largest gradient) stay below it on both sides) over one net's
    tensors."""
    largest = max(float(w.abs().max()) for w in want.values())
    cos_min, norm_max, rel_max, noise_ok = 1.0, 0.0, 0.0, True
    for n, w in want.items():
        g, scale = got[n].double(), float(w.abs().max())
        w = w.double()
        if scale <= 1e-5 * largest:
            noise_ok &= float(g.abs().max()) <= 1e-5 * largest
            continue
        cos_min = min(cos_min, float((g * w).sum() / (g.norm() * w.norm())))
        norm_max = max(norm_max, abs(float(g.norm() / w.norm()) - 1))
        rel_max = max(rel_max, float((g - w).abs().max()) / scale)
    return cos_min, norm_max, rel_max, noise_ok


def cuda_step_vs_cpu(family, crop, batch, seed=0, f64=False):
    """One f32 step of `family` (degrade=False) on the card and on the CPU
    from the same weights and pair, and with `f64` the same step in
    float64 on the CPU: {"loss": largest relative loss difference,
    "stats": largest BN statistic difference / the tensor's largest
    magnitude, "gen"/"disc": _grad_readings, each of the card against the
    CPU's f32 step; with `f64` the same of the card ("*64") and of the
    CPU's f32 step ("cpu_*64") against float64; "launches": hand-kernel
    launches during the card's step}."""
    cfg = tconfig.make_config(family, crop_size=crop, batch_size=batch)
    bundle = build_models(family, scale=cfg.scale)
    rng = np.random.default_rng(seed)
    lr = crop // cfg.scale if bundle.upscales else crop
    img_in = _t((rng.random((batch, lr, lr, 3)) * 2 - 1).astype(np.float32))
    img_tgt = _t((rng.random((batch, crop, crop, 3)) * 2 - 1).astype(
        np.float32))
    step = build_train_step(bundle, cfg, degrade=False)
    states, metrics = {}, {}
    runs = {"cuda": ("cuda", torch.float32), "cpu": ("cpu", torch.float32)}
    if f64:
        runs["f64"] = ("cpu", torch.float64)
    for key, (dev, dtype) in runs.items():
        states[key] = create_train_state(bundle, cfg, dev, seed=seed)
        vgg = init_vgg_params(device=dev)
        for m in (states[key].gen.model, states[key].disc.model, vgg):
            m.to(dtype)
        gen = torch.Generator(device=dev).manual_seed(seed)
        masks = None
        if family == "pix2pix":
            # the same dropout masks on both devices
            g = torch.Generator().manual_seed(seed + 1)
            shapes = [(batch, s, s, 512) for s in (2, 4, 8)]
            masks = tuple([(torch.rand(sh, generator=g) < 0.5).to(dev)
                           for sh in shapes] for _ in range(2))
        before = _hand_launches()
        metrics[key] = {k: float(v) for k, v in step(
            states[key], vgg, (img_in.to(dev, dtype), img_tgt.to(dev, dtype)),
            gen, dropout=masks).items()}
        if key == "cuda":
            launches = _hand_launches() - before
    grads = {k: _recovered(states[k]) for k in states}
    out = {"launches": launches}
    # (prefix, suffix) of the keys: card vs CPU, card vs and CPU vs f64
    pairs = {("", ""): ("cuda", "cpu")}
    if f64:
        pairs.update({("", "64"): ("cuda", "f64"),
                      ("cpu_", "64"): ("cpu", "f64")})
    for (pre, suf), (a, b) in pairs.items():
        out[f"{pre}loss{suf}"] = max(
            abs(metrics[a][k] - v) / max(abs(v), 1e-30)
            for k, v in metrics[b].items())
        stats = 0.0
        for net in ("gen", "disc"):
            out[f"{pre}{net}{suf}"] = _grad_readings(grads[a][net],
                                                     grads[b][net])
            want = dict(getattr(states[b], net).model.named_buffers())
            for n, buf in getattr(states[a], net).model.named_buffers():
                w = want[n].double().cpu()
                stats = max(stats, float((buf.double().cpu() - w).abs().max())
                            / max(float(w.abs().max()), 1e-30))
        out[f"{pre}stats{suf}"] = stats
    return out


def cuda_disc_same_inputs(seed=0):
    """The autoencoder step's discriminator half (train mode, BCE of
    probabilities) on the card and on the CPU, given the same fake (the
    CPU generator's output) and given each device's own: _grad_readings
    of the card's gradients against the CPU's in each case, and the
    largest difference of the two fakes."""
    cfg = tconfig.make_config("autoencoder", crop_size=64, batch_size=2)
    bundle = build_models("autoencoder")
    rng = np.random.default_rng(seed)
    a, b = (_t((rng.random((2, 64, 64, 3)) * 2 - 1).astype(np.float32))
            for _ in range(2))
    nets, fakes = {}, {}
    for dev in ("cpu", "cuda"):
        nets[dev] = create_train_state(bundle, cfg, dev, seed=seed)
        with torch.no_grad(), no_tf32():
            fakes[dev] = nets[dev].gen.model(a.to(dev))

    def grads(dev, fake):
        d = nets[dev].disc.model
        d.zero_grad()
        with no_tf32():
            tlosses.discriminator_loss(d(b.to(dev)), d(fake.to(dev)),
                                       False).backward()
        return {n: p.grad.cpu() for n, p in d.named_parameters()}

    want = grads("cpu", fakes["cpu"])
    return {"same": _grad_readings(grads("cuda", fakes["cpu"]), want),
            "own": _grad_readings(grads("cuda", fakes["cuda"]), want),
            "fake_diff": float((fakes["cuda"].cpu() - fakes["cpu"]).abs()
                               .max())}


def cuda_ops_vs_cpu():
    """Train-mode BatchNorm (f32 output and new statistics; bf16 output's
    share beyond one bf16 ulp), the JPEG round trip and degrade_pair at
    scale 4 (share of values > 1e-4 apart) on the card against the CPU."""
    rng = np.random.default_rng(3)
    x = _t((rng.standard_normal((4, 16, 20, 24)) * 2 + 0.5).astype(
        np.float32))
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        res = []
        for dev in ("cpu", "cuda"):
            bn = BatchNorm(16, momentum=0.8).to(dev).train()
            y = bn(x.to(dev, dt))
            res.append((y.float().cpu(), bn.mean.cpu(), bn.var.cpu()))
        (y0, m0, v0), (y1, m1, v1) = res
        mag = torch.maximum(y0.abs(), y1.abs())
        ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=1e-30))) - 7)
        out[str(dt)] = {
            "y_rel": float((y1 - y0).abs().max() / y0.abs().max()),
            "y_ulp_share": float(((y1 - y0).abs() > ulp).float().mean()),
            "mean_rel": float((m1 - m0).abs().max() / m0.abs().max()),
            "var_rel": float((v1 - v0).abs().max() / v0.abs().max())}
    img = torch.rand(3, 64, 96, 3, generator=torch.Generator().manual_seed(4))
    q = torch.tensor([20.0, 50.0, 90.0])
    j0 = tjpeg.jpeg_roundtrip(img, q)
    j1 = tjpeg.jpeg_roundtrip(img.cuda(), q.cuda()).cpu()
    d0 = degrade_pair(img, 4, q)[0]
    d1 = degrade_pair(img.cuda(), 4, q.cuda())[0].cpu()
    out["jpeg_share"] = float(((j1 - j0).abs() > 1e-4).float().mean())
    out["degrade_share"] = float(((d1 - d0).abs() > 1e-4).float().mean())
    return out


def cuda_trainer_cli(workdir):
    """train_fsrgan_torch.py's main on the card (no --device) for an epoch
    of two steps in `workdir` on seeded .npy images: (device of the final
    state, exports read back on the card equal to it, hand-kernel
    launches)."""
    old = os.getcwd()
    os.chdir(workdir)
    try:
        d = os.path.join("data", "cls")
        os.makedirs(d)
        rng = np.random.default_rng(0)
        for i in range(4):
            np.save(os.path.join(d, f"{i}.npy"),
                    (rng.random((70, 80, 3)) * 255).astype(np.uint8))
        argv = ["--image_dir", "data", "--batch_size", "2", "--crop_size",
                "64", "--data_workers", "2"]
        before = _hand_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            state = tloop.main("fsrgan", argv)
        launches = _hand_launches() - before
        cfg = tconfig.parse_args("fsrgan", argv)
        bundle = build_models("fsrgan")
        fresh = create_train_state(bundle, cfg, "cuda", seed=5)
        tck.load_export_into(f"models/{cfg.model_name}.dgt", fresh.gen.model)
        tck.load_export_into(f"models/{cfg.model_name}_disc.dgt",
                             fresh.disc.model)
        equal = (not _equal_states(fresh.gen.model.state_dict(),
                                   state.gen.model.state_dict())
                 and not _equal_states(fresh.disc.model.state_dict(),
                                       state.disc.model.state_dict()))
        return (str(next(state.gen.model.parameters()).device), equal,
                launches, state.step)
    finally:
        os.chdir(old)
