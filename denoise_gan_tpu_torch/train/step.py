"""The joint G+D training step (denoise_gan_tpu/train/step.py:45-194), in
plain PyTorch: the JAX step runs no Pallas kernel, and neither does this.

One step: the degradation of the HR batch (data/degrade.py), the
generator's loss and gradients, the discriminator's loss and gradients,
then both Adam updates from the same forward (a joint update, no
alternation), as the JAX step and the reference do.  The semantics kept:
* the generator's loss calls D(fake) in train mode (batch statistics)
  and throws its running-statistics update away;
* D's loss runs D(real) and then D(fake) as two forwards whose
  running-statistics updates chain (never one concatenated batch, which
  would change the batch statistics), on ``fake`` detached;
* pix2pix's identity loss is a second generator forward, on the target,
  with its own dropout draw and its statistics update thrown away;
* the totals: autoencoder, srgan, fsrgan content + adv + mae; pix2pix adv
  + var + mae + mse + content + identity (adv = 1e-3 BCE, var = 1e-5 TV);
  FSRGAN's D loss halved;
* PSNR every step (SSIM is left to the loop's summaries).
The step runs with TF32 off and, on the CPU, without oneDNN
(utils/device.py::exact_f32), so that f32 is f32.

Data parallelism (``mesh``, parallel/mesh.py), what GSPMD does for the
JAX step under its mesh: each rank steps on its rows of the global batch;
BatchNorm's training statistics are the global batch's
(models/layers.py); the JPEG qualities and pix2pix's dropout masks are
drawn over the global batch, in the one-process step's order, each rank
keeping its rows; both nets' gradients are summed over the ranks and
divided by their number between the backward passes and the updates
(explicitly: DistributedDataParallel's hooks would fight the two nets,
the two D forwards and pix2pix's second G forward); the metrics are the
ranks' mean.  Every rank applies the same gradients, so the replicas stay
bit-identical.
"""

from __future__ import annotations

from typing import Callable

import torch

from denoise_gan_tpu_torch.data.degrade import degrade_pair
from denoise_gan_tpu_torch.losses.gan import (
    adversarial_loss, discriminator_loss, l1_loss, l2_loss, tv_loss,
)
from denoise_gan_tpu_torch.models import ModelBundle
from denoise_gan_tpu_torch.models.layers import batch_stats_frozen
from denoise_gan_tpu_torch.models.vgg import content_features
from denoise_gan_tpu_torch.ops.image import renorm
from denoise_gan_tpu_torch.ops.metrics import psnr
from denoise_gan_tpu_torch.parallel.mesh import (
    GlobalDraw, Mesh, all_mean, batch_sharding, data_only,
)
from denoise_gan_tpu_torch.train.state import GANTrainState
from denoise_gan_tpu_torch.utils.config import TrainConfig
from denoise_gan_tpu_torch.utils.device import exact_f32, no_tf32

# the step's parts, in order, as ``mark`` names them
PARTS = ("degrade", "generator", "disc_in_gen_loss", "vgg", "gen_backward",
         "disc_forward", "disc_backward", "optimizers")


def _grads(loss: torch.Tensor, params: list[torch.nn.Parameter]
           ) -> list[torch.Tensor]:
    """d loss / d params, zeros where a parameter does not take part (as
    JAX's grad gives)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def _update(net, grads: list[torch.Tensor], count: int) -> None:
    """One Adam update at the schedule's rate for `count` (the
    optimizer's count before the update, as optax reads it)."""
    for group in net.opt.param_groups:
        group["lr"] = net.schedule(count)
    for p, g in zip(net.model.parameters(), grads):
        p.grad = g
    net.opt.step()
    net.opt.zero_grad(set_to_none=True)


def build_train_step(bundle: ModelBundle, cfg: TrainConfig,
                     degrade: bool = True, mesh: Mesh | None = None
                     ) -> Callable:
    """step(state, vgg, batch, generator=None, dropout=None, mark=None) ->
    metrics (0-dim tensors on the state's device), updating `state` in
    place and counting its step.

    `batch`: the NHWC [0, 1] HR batch, or with ``degrade=False`` a
    pre-degraded ``(img_in, img_tgt)`` pair in [-1, 1]; with a `mesh` of
    more than one rank, this rank's rows of the global batch
    (parallel/mesh.py::shard_batch).  `generator`: the torch.Generator (on
    the batch's device, seeded alike on every rank) of the random JPEG
    qualities (``cfg.jpeg_quality`` 0: 25..75 per image) and of pix2pix's
    dropout.  `dropout` (pix2pix): instead of draws, the masks of the main
    and the identity pass, two lists of three NHWC boolean masks
    (models/pix2pix.py), this rank's rows.  `mark(part)` is called as each
    of PARTS ends (timing; None: not called)."""
    from_logits = not bundle.disc_sigmoid
    family = bundle.name
    data_only(mesh, "the training step")
    shard = batch_sharding(mesh) if mesh is not None and mesh.size > 1 \
        else None

    def disc_apply(disc, cond, img):
        return disc(cond, img) if bundle.conditional_disc else disc(img)

    def gen_apply(gen, x, drop):
        return gen(x, drop) if family == "pix2pix" else gen(x)

    def step(state: GANTrainState, vgg, batch, generator=None,
             dropout=None, mark=None) -> dict[str, torch.Tensor]:
        mark = mark or (lambda part: None)
        gen, disc = state.gen.model, state.disc.model
        draw = generator if shard is None else GlobalDraw(generator, shard)
        drop_main, drop_ident = dropout or (draw, draw)
        with exact_f32():
            if degrade:
                img_in, img_tgt = degrade_pair(
                    batch, cfg.scale, max(cfg.jpeg_quality, 1), generator,
                    random_quality=cfg.jpeg_quality <= 0, shard=shard)
            else:
                img_in, img_tgt = batch
            mark("degrade")

            # ---------------- generator loss & grads ----------------
            gen_out = gen_apply(gen, img_in, drop_main)
            mark("generator")
            with batch_stats_frozen(disc):
                disc_fake = disc_apply(disc, img_in, gen_out)
            mark("disc_in_gen_loss")
            with torch.no_grad():
                tgt_features = content_features(vgg, img_tgt)
            cont = l2_loss(tgt_features, content_features(vgg, gen_out))
            mark("vgg")
            adv = 1e-3 * adversarial_loss(disc_fake, from_logits)
            mse = l2_loss(img_tgt, gen_out)
            mae = l1_loss(img_tgt, gen_out)
            var = 1e-5 * tv_loss(img_tgt, gen_out)
            if family == "pix2pix":
                with batch_stats_frozen(gen):
                    ident_out = gen_apply(gen, img_tgt, drop_ident)
                identity = l1_loss(img_tgt, ident_out)
                gen_total = adv + var + mae + mse + cont + identity
            else:
                identity = torch.zeros((), device=gen_out.device)
                gen_total = cont + adv + mae
            gen_params = list(gen.parameters())
            gen_grads = _grads(gen_total, gen_params)
            mark("gen_backward")

            # ---------------- discriminator loss & grads ----------------
            fake = gen_out.detach()
            disc_real = disc_apply(disc, img_in, img_tgt)
            disc_fake2 = disc_apply(disc, img_in, fake)
            disc_total = discriminator_loss(disc_real, disc_fake2,
                                            from_logits,
                                            half=family == "fsrgan")
            mark("disc_forward")
            disc_grads = _grads(disc_total, list(disc.parameters()))
            if shard is not None:
                grads = all_mean(gen_grads + disc_grads)
                gen_grads = grads[:len(gen_grads)]
                disc_grads = grads[len(gen_grads):]
            mark("disc_backward")

            # ---------------- optimizer updates ----------------
            _update(state.gen, gen_grads, state.step)
            _update(state.disc, disc_grads, state.step)
            mark("optimizers")
            state.step += 1

            with torch.no_grad():
                quality = psnr(renorm(fake), renorm(img_tgt)).mean()
        metrics = dict(gen_loss=gen_total, disc_loss=disc_total,
                       psnr=quality, adv_loss=adv, content_loss=cont,
                       mse_loss=mse, mae_loss=mae, var_loss=var,
                       identity_loss=identity)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if shard is not None:
            metrics = dict(zip(metrics, all_mean(
                [v.float() for v in metrics.values()])))
        return metrics

    return step


def make_eval_fn(bundle: ModelBundle) -> Callable:
    """forward(gen, x): the generator in eval mode (running statistics, no
    dropout), without gradients, its mode restored after."""

    def forward(gen: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
        was = gen.training
        gen.eval()
        try:
            with torch.no_grad(), no_tf32():
                return gen(x)
        finally:
            gen.train(was)

    return forward
