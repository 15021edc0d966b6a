"""The host side of the data (denoise_gan_tpu/data/pipeline.py): image
decoding for the CLIs and the trainers, and the trainers' DataPipeline,
which lists image_dir/*/* (or image_dir/*), decodes to f32 [0, 1], resizes
an image smaller than the crop up to (crop, crop), crops each image of a
batch at random and yields (B, crop, crop, 3) f32 batches; the
degradation runs on the device (data/degrade.py).

Decoding follows the JAX package's order: ``.npy`` read directly, else
the native libjpeg/libpng codec (data/native.py, built from the
repository's native/imgcodec.cpp), else cv2, else PIL.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from denoise_gan_tpu_torch.data import native
from denoise_gan_tpu_torch.ops.image import resize_bicubic
from denoise_gan_tpu_torch.utils.config import TrainConfig


def _cv2():
    """cv2, or None where it is not installed (imported at the call, so
    that a process without it can be rehearsed)."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def list_images(image_dir: str) -> list[str]:
    """image_dir/*/* sorted, as the reference globs; else the files of
    image_dir/*."""
    paths = sorted(glob.glob(os.path.join(image_dir, "*", "*")))
    if not paths:
        paths = sorted(p for p in glob.glob(os.path.join(image_dir, "*"))
                       if os.path.isfile(p))
    return paths


def decoder() -> str:
    """The decoder decode_image uses for an image file here: "native",
    "cv2", "PIL" or "none"."""
    if native.available():
        return "native"
    if _cv2() is not None:
        return "cv2"
    try:
        import PIL  # noqa: F401
    except ImportError:
        return "none"
    return "PIL"


def decode_image(path: str) -> np.ndarray:
    """Decode to RGB float32 [0, 1] (HWC): ``.npy`` directly (uint8 / 255,
    the first three channels), else by the native codec (a file it cannot
    read goes on to the next), else by cv2, else by PIL; without any a
    RuntimeError that names ``.npy``."""
    if path.endswith(".npy"):
        img = np.load(path)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        return np.ascontiguousarray(img[..., :3].astype(np.float32))
    img = native.decode(path)
    if img is not None:
        return img.astype(np.float32) / 255.0
    cv2 = _cv2()
    if cv2 is not None:
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is None:
            raise IOError(f"cannot decode {path}")
        return bgr[..., ::-1].astype(np.float32) / 255.0
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"cannot decode {path}: no image decoder (the "
                           "native codec, cv2 or PIL) is available; give "
                           "the image as .npy "
                           "(HWC, uint8 or float in [0, 1])") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def _resize_up_if_needed(img: np.ndarray, crop: int) -> np.ndarray:
    """An image smaller than the crop on either side, resized to (crop,
    crop) bicubic: by cv2 (a = -0.75) where cv2 is installed, as the JAX
    package does, else by JAX's cubic (a = -0.5, ops/image.py::
    resize_bicubic), the JAX package's fallback.  The card's machine has
    no cv2."""
    h, w = img.shape[:2]
    if h >= crop and w >= crop:
        return img
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, (crop, crop), interpolation=cv2.INTER_CUBIC)
    return resize_bicubic(torch.from_numpy(np.ascontiguousarray(img)),
                          crop, crop).numpy()


class DataPipeline:
    """Yields HR crop batches (B, crop, crop, 3) f32 in [0, 1], as the JAX
    package's: the files of this process's shard (``process_index``-th of
    every ``process_count``), an epoch of len(self) = images // batch
    steps (the remainder dropped; every shard runs the all-shard
    minimum), the order a numpy permutation and each batch's crops from
    its own numpy seed, both from one generator seeded by ``cfg.seed``,
    batches built by a thread pool behind a bounded queue, a decode error
    raised in the consumer, and decoded images cached when
    ``cfg.cache_images``."""

    def __init__(self, cfg: TrainConfig, seed: int | None = None,
                 process_index: int = 0, process_count: int = 1):
        self.cfg = cfg
        self.crop = cfg.crop_size
        self.batch_size = cfg.batch_size
        paths = list_images(cfg.image_dir)
        if not paths:
            raise FileNotFoundError(f"no images under {cfg.image_dir}")
        self.paths = paths[process_index::process_count]
        self.train_size = len(paths) // process_count
        self._rng = np.random.default_rng(cfg.seed if seed is None else seed)
        self._cache: dict[str, np.ndarray] = {}
        self._cache_enabled = bool(cfg.cache_images)
        self._pool = ThreadPoolExecutor(max_workers=max(1, cfg.data_workers))

    def __len__(self) -> int:
        return self.train_size // self.batch_size

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def _load(self, path: str) -> np.ndarray:
        img = self._cache.get(path)
        if img is None:
            img = _resize_up_if_needed(decode_image(path), self.crop)
            if self._cache_enabled:
                self._cache[path] = img
        return img

    def _crop(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        h, w = img.shape[:2]
        y = rng.integers(0, h - self.crop + 1)
        x = rng.integers(0, w - self.crop + 1)
        return img[y:y + self.crop, x:x + self.crop, :]

    def epoch(self, prefetch: int = 4) -> Iterator[np.ndarray]:
        """One shuffled pass, batches assembled by worker threads and
        staged through a queue of `prefetch` so that decoding overlaps the
        device's work."""
        order = self._rng.permutation(len(self.paths))
        steps = len(self)
        seeds = self._rng.integers(0, 2**63 - 1, size=steps)
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def make_batch(step_idx: int) -> np.ndarray:
            rng = np.random.default_rng(seeds[step_idx])
            idxs = order[step_idx * self.batch_size:
                         (step_idx + 1) * self.batch_size]
            imgs = list(self._pool.map(self._load,
                                       [self.paths[i] for i in idxs]))
            return np.stack([self._crop(im, rng) for im in imgs])

        def put(item) -> bool:
            """Queue `item` unless the consumer has stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # an exception (a corrupt image) goes through the queue and is
            # raised in the consumer, not swallowed into a short epoch
            try:
                for s in range(steps):
                    if not put(make_batch(s)):
                        return
                put(None)
            except BaseException as exc:  # noqa: BLE001 -- forwarded
                put(exc)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            t.join(timeout=60)
