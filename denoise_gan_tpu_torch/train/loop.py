"""The training loop and the trainers' entry point, shared by the four
families (denoise_gan_tpu/train/loop.py): the directory layout,
steps per epoch and the save_iter clamp, restore-if-retrain (or a warm
start from the last exports), the epoch loop with its per-epoch print,
a checkpoint every ``ckpt_every_epochs`` epochs and at exit, and at
SIGTERM; scalars, the 16 image panels and SSIM every ``save_iter`` steps;
the final exports ``models/<name>.dgt``, ``models/<name>_disc.dgt`` and a
timestamped backup copy of the generator's.

Each process drives one device: the card (``--device cuda``, the default;
without a GPU it raises) or the CPU (``--device cpu``).  Under ``torchrun``
the processes are the ranks of one data-parallel run (parallel/mesh.py),
as the JAX loop's hosts are: ``--batch_size`` is one host's batch, a step
takes ``batch_size`` x hosts images split evenly over the ranks, each rank
reading its own shard of the files; ``--num_devices`` 0 means every rank,
any other number must be theirs.  ``--device cuda`` gives rank r the card
cuda:LOCAL_RANK and NCCL; a named card (``cuda:0``) is shared over gloo.
Only rank 0 writes (TensorBoard, checkpoints, exports); the other ranks
take the same steps.  At the end the ranks check that their parameters
agree and print their checksums.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import signal
import time

import torch

from denoise_gan_tpu_torch.data.degrade import degrade_pair
from denoise_gan_tpu_torch.data.pipeline import DataPipeline
from denoise_gan_tpu_torch.io.checkpoint import (
    CheckpointManager, export_net, load_export_into,
)
from denoise_gan_tpu_torch.models import ModelBundle, build_models
from denoise_gan_tpu_torch.models.vgg import init_vgg_params
from denoise_gan_tpu_torch.ops.image import (
    high_pass_x_y, renorm, sobel_variation, to_uint8, total_variation_map,
)
from denoise_gan_tpu_torch.ops.metrics import ssim
from denoise_gan_tpu_torch.parallel.mesh import (
    all_sum, checksum, init_distributed, make_mesh, replicated,
    same_on_all_ranks,
)
from denoise_gan_tpu_torch.train.state import (
    GANTrainState, create_train_state, model_summary, param_count,
)
from denoise_gan_tpu_torch.train.step import build_train_step, make_eval_fn
from denoise_gan_tpu_torch.utils.config import (
    TrainConfig, get_path, parse_args,
)
from denoise_gan_tpu_torch.utils.logging import (
    SummaryWriter, timestamped_run_dir,
)
from denoise_gan_tpu_torch.utils.profiling import (
    StepTimer, check_finite, trace,
)

SCALAR_KEYS = ("gen_loss", "adv_loss", "content_loss", "mse_loss", "mae_loss",
               "var_loss", "identity_loss", "disc_loss", "psnr", "ssim")


def build_summary_fn(bundle: ModelBundle, cfg: TrainConfig):
    """summaries(gen, hr01) -> ({tag: uint8 HWC panel}, SSIM): the first
    image of the batch degraded as the step does (a random quality drawn
    from a generator seeded by ``cfg.seed`` where ``--jpeg_quality 0``),
    the generator in eval mode, and the 16 panels of the reference."""
    forward = make_eval_fn(bundle)

    def summaries(gen: torch.nn.Module, hr01: torch.Tensor):
        g = torch.Generator(device=hr01.device).manual_seed(cfg.seed)
        with torch.no_grad():
            img_in, img_tgt = degrade_pair(
                hr01[:1], cfg.scale, max(cfg.jpeg_quality, 1), g,
                random_quality=cfg.jpeg_quality <= 0)
            img_gen = forward(gen, img_in).float()
            ssim_val = ssim(renorm(img_gen), renorm(img_tgt)).mean()
            err = img_gen - img_tgt
            dx_gen, dy_gen = high_pass_x_y(img_gen)
            dx_tgt, dy_tgt = high_pass_x_y(img_tgt)

            def raw(x):
                return to_uint8(x, norm=False)

            panels = {
                "Images/Input": to_uint8(img_in),
                "Images/Target": to_uint8(img_tgt),
                "Images/Generated": to_uint8(img_gen),
                "Error/Square Error (MSE)": raw(err.square()),
                "Error/Absolute Error (MAE)": raw(err.abs()),
                "Error/Sobel Variation": raw(sobel_variation(err)),
                "Error/Total Variation": raw(total_variation_map(err)),
                "Image Gradients/Sobel Input": raw(sobel_variation(img_in)),
                "Image Gradients/Sobel Target": raw(sobel_variation(img_tgt)),
                "Image Gradients/Sobel Generated": raw(
                    sobel_variation(img_gen)),
                "Image Gradients/dx Target": raw(dx_tgt),
                "Image Gradients/dy Target": raw(dy_tgt),
                "Image Gradients/dx Generated": raw(dx_gen),
                "Image Gradients/dy Generated": raw(dy_gen),
                "Image Gradients/Total Var Target": raw(
                    total_variation_map(img_tgt)),
                "Image Gradients/Total Var Generated": raw(
                    total_variation_map(img_gen)),
            }
        return ({k: v[0].cpu().numpy() for k, v in panels.items()},
                float(ssim_val))

    return summaries


def warm_start_from_exports(state: GANTrainState,
                            model_name: str) -> GANTrainState:
    """Both nets from a prior run's exports (``models/<name>.dgt`` and
    ``models/<name>_disc.dgt``) where they exist, when no checkpoint does:
    the reference's --retrain reload.  Optimizers and counters start
    fresh."""
    for path, model, what in (
            (get_path("models", f"{model_name}.dgt"), state.gen.model,
             "generator"),
            (get_path("models", f"{model_name}_disc.dgt"),
             state.disc.model, "discriminator")):
        if os.path.exists(path):
            print(f"Warm-starting {what} from export:", path)
            load_export_into(path, model)
    return state


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _NullWriter:
    """The SummaryWriter of the ranks other than 0: writes nothing."""

    def scalar(self, *a, **k):
        pass

    def scalars(self, *a, **k):
        pass

    def image(self, *a, **k):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def _preempted(flag: bool, dev: torch.device, ranks: int) -> bool:
    """Whether any rank has had a SIGTERM (one all-reduce where there are
    several ranks, so that they stop at the same step)."""
    if ranks == 1:
        return flag
    return bool(all_sum(torch.tensor([float(flag)], device=dev)).item())


def resume_step(manager: CheckpointManager | None, mesh) -> int | None:
    """The step of the checkpoint that `manager` would restore (None: none
    or no manager), checked to be the same on every rank: each rank
    restores the checkpoint itself, since replicated() sends parameters
    and buffers but not the optimizers' moments or the step count.  A rank
    that finds another (a checkpoint directory that not every rank reads)
    raises RuntimeError on every rank."""
    latest = manager.latest_step() if manager else None
    if not same_on_all_ranks(-1.0 if latest is None else latest,
                             mesh.device):
        where = manager.ckpt_dir if manager else "its checkpoint directory"
        raise RuntimeError(
            f"rank {mesh.rank} finds checkpoint step {latest} under {where} "
            "and another rank finds another; resuming on several ranks "
            "needs the checkpoints on a filesystem that every rank reads")
    return latest


def batch_split(batch_size: int, hosts: int, ranks: int) -> tuple[int, bool]:
    """The global batch (`batch_size` a host) and whether the ranks split
    it, by the JAX loop's rule: a global batch the ranks do not divide
    raises a ValueError, except a batch of one on one host, which trains
    as one device would (every rank steps the same batch unsplit, so the
    ranks stay equal)."""
    global_bs = batch_size * hosts
    if global_bs % ranks:
        if hosts > 1:
            raise ValueError(
                f"multi-host training requires the global batch "
                f"({batch_size} per host x {hosts} hosts = "
                f"{global_bs}) to be divisible by the {ranks} devices; "
                "adjust --batch_size")
        if batch_size > 1:
            raise ValueError(
                f"global batch {global_bs} not divisible by {ranks} devices")
    return global_bs, global_bs % ranks == 0


def train(cfg: TrainConfig, family: str) -> GANTrainState:
    """A whole run on ``cfg.device`` (under torchrun: this rank's part of
    it); returns the final state."""
    init_distributed(device=cfg.device)
    mesh = make_mesh(cfg.num_devices, device=cfg.device)
    dev, ranks = mesh.device, mesh.size
    primary = mesh.rank == 0
    global_bs, split = batch_split(cfg.batch_size, mesh.hosts, ranks)

    ckpt_dir = get_path("models/checkpoints", cfg.model_name)
    backup_dir = get_path("models/backups", cfg.model_name)
    if primary:
        os.makedirs(ckpt_dir, exist_ok=True)
        os.makedirs(backup_dir, exist_ok=True)
        os.makedirs(cfg.logdir, exist_ok=True)

    if split:   # each rank's shard of the files and its rows of the batch
        pipeline = DataPipeline(
            dataclasses.replace(cfg, batch_size=global_bs // ranks),
            process_index=mesh.rank, process_count=ranks)
    else:       # a batch of one: every rank reads all the files
        pipeline = DataPipeline(cfg)
    steps_per_epoch = len(pipeline)
    if steps_per_epoch == 0:
        pipeline.close()
        raise ValueError(
            f"dataset too small: {pipeline.train_size} image(s) under "
            f"{cfg.image_dir} yields 0 steps at --batch_size "
            f"{cfg.batch_size} (drop_remainder semantics); add images or "
            f"lower --batch_size")
    print(f"Steps per epoch: {steps_per_epoch}")
    if cfg.save_iter > steps_per_epoch:
        cfg.save_iter = max(steps_per_epoch, 1)
        print(f"Modified save_iter: {cfg.save_iter}")

    if primary:
        run_dir = timestamped_run_dir(cfg.logdir, cfg.model_name)
        writer = SummaryWriter(run_dir)
        print("Created Tensorboard Summary here:", run_dir)
    else:
        writer = _NullWriter()

    bundle = build_models(family, scale=cfg.scale, fp16=bool(cfg.fp16))
    state = create_train_state(bundle, cfg, dev)
    print(model_summary(f"{family}_generator", state.gen.model))
    print(model_summary(f"{family}_discriminator", state.disc.model))
    print(f"Generator params: {param_count(state.gen.model):,}  "
          f"Discriminator params: {param_count(state.disc.model):,}  "
          f"device: {dev}" + (f", rank {mesh.rank} of {ranks}"
                              if ranks > 1 else ""))
    vgg = init_vgg_params(device=dev)

    manager = (CheckpointManager(ckpt_dir, max_to_keep=cfg.max_to_keep)
               if primary or os.path.isdir(ckpt_dir) else None)
    try:
        latest = resume_step(manager if cfg.retrain else None, mesh)
        if latest is not None:
            print("Restoring checkpoint from here:", ckpt_dir)
            state = manager.restore(state)
        elif cfg.retrain:
            state = warm_start_from_exports(state, cfg.model_name)
        replicated([state.gen.model, state.disc.model], mesh)

        step_fn = build_train_step(bundle, cfg, mesh=mesh if split else None)
        summary_fn = build_summary_fn(bundle, cfg)
        rng = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
        timer = state.timer = StepTimer(global_bs)

        # checkpoint and stop after the step in flight at a SIGTERM
        preempted = {"flag": False}

        def _on_sigterm(signum, frame):
            preempted["flag"] = True

        try:
            old_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            old_handler = None          # not on the main thread

        try:
            metrics = {}
            it = state.step
            epoch0 = state.epoch
            for epoch in range(cfg.epochs):
                state.epoch += 1
                print(f"|== Starting epoch: {epoch0 + epoch + 1}, ", end="",
                      flush=True)
                train_begin = time.time()
                last_batch = None
                profile_this_epoch = bool(cfg.profile_dir) and epoch == min(
                    1, cfg.epochs - 1)  # an epoch after the warm-up
                with trace(cfg.profile_dir if profile_this_epoch else None):
                    for hr in pipeline.epoch():
                        hr = torch.from_numpy(hr).to(dev, non_blocking=True)
                        last_batch = hr
                        metrics = step_fn(state, vgg, hr, rng)
                        timer.tick()
                        it += 1
                        # several ranks agree at the log points only
                        if (ranks == 1 or it % cfg.save_iter == 0) and \
                                _preempted(preempted["flag"], dev, ranks):
                            print(f"\nSIGTERM: checkpointing at step {it} "
                                  "and exiting")
                            if primary:
                                manager.save(it, state)
                            return state
                        if it % cfg.save_iter != 0:
                            continue
                        host = {k: float(metrics[k]) for k in SCALAR_KEYS
                                if k in metrics}
                        if cfg.check_numerics:
                            check_finite(host, it)
                        writer.scalars(
                            {f"Generator Losses/{k}": v for k, v in
                             host.items()
                             if k not in ("disc_loss", "psnr", "ssim")}, it)
                        writer.scalar("Discriminator Losses/disc_loss",
                                      host["disc_loss"], it)
                        writer.scalar("Quality/psnr", host["psnr"], it)
                        panels, ssim_val = summary_fn(state.gen.model,
                                                      last_batch)
                        writer.scalar("Quality/ssim", ssim_val, it)
                        if cfg.log_images:
                            for tag, img in panels.items():
                                writer.image(tag, img, it)
                        writer.flush()
                _sync(dev)
                train_time = time.time() - train_begin

                if cfg.ckpt and epoch % cfg.ckpt_every_epochs == 0 \
                        and primary:
                    manager.save(it, state)
                total_time = time.time() - train_begin
                sps = steps_per_epoch / max(train_time, 1e-9)
                print(
                    f"disc_loss: {float(metrics['disc_loss']):.2e}, "
                    f"adv_loss: {float(metrics['adv_loss']):.2e}, "
                    f"vgg: {float(metrics['content_loss']):.2e}, "
                    f"mse: {float(metrics['mse_loss']):.2e}, "
                    f"mae: {float(metrics['mae_loss']):.2e}, "
                    f"psnr: {float(metrics['psnr']):.2f}, "
                    f"iters: {it}, train: {train_time:0.2f}, "
                    f"total: {total_time:0.2f}, steps/s: {sps:0.2f}, "
                    f"run steps/s: {timer.steps_per_sec:0.2f}, "
                    f"imgs/s: {timer.images_per_sec:0.1f} ==|")
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)

        if cfg.ckpt and primary:
            manager.save(it, state)

        if ranks > 1:
            total = checksum(state.gen.model, state.disc.model)
            print(f"rank {mesh.rank} of {ranks}: parameter checksum "
                  f"{total!r}")
            if not same_on_all_ranks(total, dev):
                raise RuntimeError("the ranks' parameters differ after "
                                   "training")

        if cfg.save_model and primary:
            short = time.strftime("%m%d_%H%M")
            gen_path = get_path("models", f"{cfg.model_name}.dgt")
            export_net(gen_path, family, cfg.scale, state.gen.model)
            shutil.copyfile(gen_path, os.path.join(
                backup_dir, f"{cfg.model_name}_{short}.dgt"))
            export_net(get_path("models", f"{cfg.model_name}_disc.dgt"),
                       family, cfg.scale, state.disc.model,
                       role="discriminator")
    finally:
        writer.close()
        pipeline.close()
    return state


def main(family: str, argv: list[str] | None = None) -> GANTrainState:
    cfg = parse_args(family, argv)
    print("COMPUTATION PARAMETERS")
    print("Compute dtype: %s" % ("bfloat16" if cfg.fp16 else "float32"))
    print("Variable dtype: float32")
    cfg.echo()
    return train(cfg, family)
