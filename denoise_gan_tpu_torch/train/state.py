"""The train state (denoise_gan_tpu/train/state.py): both nets (their f32
parameters and BatchNorm statistics), both optimizers and the step and
epoch counters, which a checkpoint keeps, so that a resumed run goes on
from its step.

Optimizers as the JAX package's (the reference's):
* autoencoder, srgan, fsrgan: Adam on an exponential decay of ``cfg.lr``
  (x0.1 at each 100,000-step staircase), the discriminator at 5x the rate
  (TTUR);
* pix2pix: Adam at a constant 2e-4, b1 0.5, for both nets.
b2 0.999 and eps 1e-7 (Keras' default, not torch's 1e-8).  The rate of an
update is the schedule at the optimizer's count before the update, as
optax reads it; train/step.py sets it before each update.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from denoise_gan_tpu_torch.models import ModelBundle
from denoise_gan_tpu_torch.utils.config import TrainConfig

DECAY_STEPS = 100_000
DECAY_RATE = 0.1
TTUR = 5.0
PIX2PIX_LR = 2e-4
B2 = 0.999
EPS = 1e-7

Schedule = Callable[[int], float]


@dataclass
class NetState:
    model: nn.Module
    opt: torch.optim.Adam
    schedule: Schedule


@dataclass
class GANTrainState:
    gen: NetState
    disc: NetState
    step: int = 0
    epoch: int = 0
    timer: object = None     # the run's StepTimer (train/loop.py), not saved

    def state_dict(self) -> dict:
        """Everything a checkpoint keeps."""
        return {"gen": self.gen.model.state_dict(),
                "gen_opt": self.gen.opt.state_dict(),
                "disc": self.disc.model.state_dict(),
                "disc_opt": self.disc.opt.state_dict(),
                "step": self.step, "epoch": self.epoch}

    def load_state_dict(self, sd: dict) -> None:
        self.gen.model.load_state_dict(sd["gen"])
        self.gen.opt.load_state_dict(sd["gen_opt"])
        self.disc.model.load_state_dict(sd["disc"])
        self.disc.opt.load_state_dict(sd["disc_opt"])
        self.step, self.epoch = int(sd["step"]), int(sd["epoch"])


def exponential_decay(init: float, transition_steps: int = DECAY_STEPS,
                      rate: float = DECAY_RATE) -> Schedule:
    """optax.exponential_decay(init, transition_steps, rate,
    staircase=True)."""
    return lambda count: init * rate ** math.floor(count / transition_steps)


def ttur_schedules(cfg: TrainConfig, family: str
                   ) -> tuple[Schedule, Schedule]:
    if family == "pix2pix":
        return (lambda count: PIX2PIX_LR), (lambda count: PIX2PIX_LR)
    return exponential_decay(cfg.lr), exponential_decay(cfg.lr * TTUR)


def make_optimizers(cfg: TrainConfig, family: str, gen: nn.Module,
                    disc: nn.Module) -> tuple[NetState, NetState]:
    """Both nets' Adam, each with its schedule."""
    gen_sched, disc_sched = ttur_schedules(cfg, family)
    b1 = 0.5 if family == "pix2pix" else 0.9

    def net(model, sched):
        return NetState(model, torch.optim.Adam(
            model.parameters(), lr=sched(0), betas=(b1, B2), eps=EPS),
            sched)

    return net(gen, gen_sched), net(disc, disc_sched)


def create_train_state(bundle: ModelBundle, cfg: TrainConfig,
                       device: torch.device | str = "cuda",
                       seed: int | None = None) -> GANTrainState:
    """Both nets in train mode on `device`, initialised in turn from one
    CPU torch.Generator seeded by `seed` (default ``cfg.seed``), and their
    optimizers.  Without a GPU a CUDA request raises RuntimeError."""
    g = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    gen = bundle.build_generator_net(device, g).train()
    disc = bundle.build_discriminator(device, g).train()
    gen_state, disc_state = make_optimizers(cfg, bundle.name, gen, disc)
    return GANTrainState(gen_state, disc_state)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def model_summary(name: str, model: nn.Module) -> str:
    """A Keras model.summary()-style table of parameters per layer (the
    reference prints both nets' before training)."""
    lines = [f'Model: "{name}"', "_" * 64,
             f"{'Layer (path)':<40}{'Param shapes':<14}{'Param #':>10}",
             "=" * 64]
    by_module: dict[str, list] = {}
    for pname, p in model.named_parameters():
        module, _, _ = pname.rpartition(".")
        by_module.setdefault(module.replace(".", "/") or pname, []).append(p)
    total = 0
    for module, leaves in by_module.items():
        n = sum(p.numel() for p in leaves)
        total += n
        shapes = ",".join("x".join(map(str, p.shape)) for p in leaves)
        lines.append(f"{module:<40}{shapes[:13]:<14}{n:>10,}")
    lines.append("=" * 64)
    stats = sum(b.numel() for b in model.buffers())
    lines.append(f"Total params: {total:,}"
                 + (f" (+ {stats:,} BatchNorm stats)" if stats else ""))
    lines.append("_" * 64)
    return "\n".join(lines)
