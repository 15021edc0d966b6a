"""The reference's ``Model(args)`` object surface (denoise_gan_tpu/models/
api.py): ``.generator``, ``.discriminator``, ``.vgg``,
``.gen_optimizer``, ``.disc_optimizer`` and ``.content_loss`` on top of
the functional pieces (models/, train/state.py).  The trainers use those
pieces directly."""

from __future__ import annotations

import torch

from denoise_gan_tpu_torch.losses.gan import content_loss as _content_loss
from denoise_gan_tpu_torch.models import build_models
from denoise_gan_tpu_torch.models.layers import batch_stats_frozen
from denoise_gan_tpu_torch.models.vgg import init_vgg_params
from denoise_gan_tpu_torch.train.state import create_train_state
from denoise_gan_tpu_torch.utils.config import TrainConfig


class _ModelAPI:
    """A family's nets (on ``cfg.device``, from `seed`), their Adam
    optimizers and the frozen VGG19 features."""

    family: str = ""

    def __init__(self, cfg: TrainConfig, seed: int = 0):
        self.cfg = cfg
        self.bundle = build_models(self.family, scale=cfg.scale,
                                   fp16=bool(cfg.fp16))
        self.state = create_train_state(self.bundle, cfg, cfg.device, seed)
        self.generator = self.state.gen.model
        self.discriminator = self.state.disc.model
        self.gen_optimizer = self.state.gen.opt
        self.disc_optimizer = self.state.disc.opt
        self.vgg = init_vgg_params(device=cfg.device)
        self.iterations = 0
        self.epochs = 0
        self.hr_shape = [cfg.crop_size, cfg.crop_size, 3]
        lr = cfg.crop_size // cfg.scale if self.bundle.upscales \
            else cfg.crop_size
        self.lr_shape = [lr, lr, 3]

    def content_loss(self, target: torch.Tensor,
                     output: torch.Tensor) -> torch.Tensor:
        """VGG19 block5_conv4 feature MSE."""
        return _content_loss(self.vgg, target, output)

    def _run(self, net: torch.nn.Module, train: bool, *args):
        """`net` in train mode (batch statistics, running ones left as
        they are) or in eval mode, without gradients; its mode restored."""
        was = net.training
        net.train(train)
        try:
            with torch.no_grad(), batch_stats_frozen(net):
                return net(*args)
        finally:
            net.train(was)

    def generate(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self._run(self.generator, train, x)

    def discriminate(self, x: torch.Tensor, y: torch.Tensor | None = None,
                     train: bool = False) -> torch.Tensor:
        args = (x, y) if self.bundle.conditional_disc else (x,)
        return self._run(self.discriminator, train, *args)


class Autoencoder(_ModelAPI):
    family = "autoencoder"


class Pix2Pix(_ModelAPI):
    family = "pix2pix"


class SRGAN(_ModelAPI):
    family = "srgan"


class FastSRGAN(_ModelAPI):
    family = "fsrgan"
