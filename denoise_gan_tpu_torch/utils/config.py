"""The trainers' configuration (denoise_gan_tpu/utils/config.py): the
reference's params-dict flags, one per TrainConfig field and typed by its
default, the per-trainer defaults, the post-parse coercions and the model
name's ``_{scale}x_{jpeg_quality}q[_fp16]`` suffix.  The flags and
defaults are the JAX package's, byte for byte, plus ``--device`` (the
card, ``cuda``, unless ``cpu`` is asked for).  ``--fp16`` means bf16
compute with f32 parameters, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from argparse import ArgumentParser
from dataclasses import dataclass
from typing import Any


def get_path(*parts: str) -> str:
    """expanduser + expandvars + realpath of the joined parts, as the JAX
    package's get_path."""
    return os.path.realpath(
        os.path.expanduser(os.path.expandvars(os.path.join(*parts))))


@dataclass
class TrainConfig:
    """The flag set shared by the four trainers."""

    model_name: str = "srgan"
    image_dir: str = "train/image_input"
    model_dir: str = "./models"
    logdir: str = "./logs"
    batch_size: int = 1
    epochs: int = 1
    crop_size: int = 256
    lr: float = 1e-3
    save_iter: int = 200
    retrain: int = 1
    save_model: int = 1
    ckpt: int = 1
    fp16: int = 0
    scale: int = 1
    jpeg_quality: int = 50

    # the JAX package's additions to the reference's flags
    seed: int = 0
    num_devices: int = 0          # 0 = every rank; else their number
    cache_images: int = 1         # cache decoded images in host RAM
    data_workers: int = 8         # host decode thread count
    ckpt_every_epochs: int = 5
    max_to_keep: int = 3
    steps_per_epoch: int = 0      # 0 = derived from dataset size
    log_images: int = 1           # write TensorBoard image panels
    bf16_rule: str = "compute"    # 'compute': bf16 activations, f32 params
    profile_dir: str = ""         # capture a torch.profiler trace of one epoch
    check_numerics: int = 1       # raise on NaN/Inf losses at log points

    # the port's own
    device: str = "cuda"          # 'cuda' (cuda:LOCAL_RANK), 'cuda:N', 'cpu'

    def suffix_model_name(self) -> None:
        """``model_name += _{scale}x_{jpeg_quality}q[_fp16]``."""
        self.model_name = self.model_name + f"_{self.scale}x_{self.jpeg_quality}q"
        if self.fp16:
            self.model_name = self.model_name + "_fp16"

    def finalize(self) -> "TrainConfig":
        """The post-parse coercions: paths resolved, the 0/1 flags to
        bools, the quality to an int."""
        self.image_dir = get_path(self.image_dir)
        self.model_dir = get_path(self.model_dir)
        self.logdir = get_path(self.logdir)
        self.retrain = bool(self.retrain)
        self.save_model = bool(self.save_model)
        self.ckpt = bool(self.ckpt)
        self.fp16 = bool(self.fp16)
        self.jpeg_quality = int(self.jpeg_quality)
        return self

    @property
    def hr_size(self) -> int:
        return self.crop_size

    @property
    def lr_size(self) -> int:
        return self.crop_size // self.scale

    def echo(self) -> None:
        """The full flag echo."""
        for k, v in dataclasses.asdict(self).items():
            print(f"  {k}:".ljust(20) + f"{v!r}".ljust(70) + f"['{type(v).__name__}']")


# Per-trainer defaults, the reference's params dicts (pix2pix with the
# scale, jpeg_quality and model_name flags its data loader reads)
TRAINER_DEFAULTS: dict[str, dict[str, Any]] = {
    "autoencoder": dict(
        model_name="autoencoder",
        image_dir="train/image_input/DIV2K_train_HR",
        fp16=0,
        scale=1,
        jpeg_quality=50,
    ),
    "pix2pix": dict(
        model_name="pix2pix",
        image_dir="~/Data/DIV2K/DIV2K_train_HR",
        retrain=0,
        fp16=0,
        scale=1,
        jpeg_quality=50,
    ),
    "srgan": dict(
        model_name="srgan",
        image_dir="train/image_input",
        fp16=1,
        scale=4,
        jpeg_quality=50,
    ),
    "fsrgan": dict(
        model_name="fsrgan",
        image_dir="train/image_input/DIV2K_train_HR",
        fp16=0,
        scale=4,
        jpeg_quality=50,
    ),
}


def make_config(trainer: str, **overrides: Any) -> TrainConfig:
    base = dict(TRAINER_DEFAULTS[trainer])
    base.update(overrides)
    return TrainConfig(**base)


def build_parser(trainer: str) -> ArgumentParser:
    """One flag per TrainConfig field, typed from the trainer's default."""
    cfg = make_config(trainer)
    parser = ArgumentParser(description=f"denoise_gan_tpu_torch {trainer} "
                                        "trainer")
    for f in dataclasses.fields(TrainConfig):
        default = getattr(cfg, f.name)
        parser.add_argument("--" + f.name, default=default, type=type(default))
    return parser


def parse_args(trainer: str, argv: list[str] | None = None,
               suffix_name: bool = True) -> TrainConfig:
    args = build_parser(trainer).parse_args(argv)
    cfg = TrainConfig(**vars(args)).finalize()
    if suffix_name:
        cfg.suffix_model_name()
    return cfg
