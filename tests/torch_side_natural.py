"""The PyTorch half of tests/test_torch_natural.py and tests/
test_torch_cv2_paths.py: the port's natural-photo tools (tools/
train_natural.py, tools/eval_natural.py), unit_test.py's NL-means filter
and the video CLI on an mp4, on the CPU.

tests/torch_process.py runs these functions in a child process
(``torch_process("torch_side_natural")``), so that no pytest worker imports
torch.  They take and return numpy arrays and plain Python values.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import os

import numpy as np
import torch

from denoise_gan_tpu_torch import unit_test
from denoise_gan_tpu_torch.infer import kernel_engine as ke
from denoise_gan_tpu_torch.infer import video as video_cli
from denoise_gan_tpu_torch.io.checkpoint import load_generator
from denoise_gan_tpu_torch.tools import eval_natural, train_natural


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def photo_crops():
    """(photo, sha256 of the crop's bytes) of eval_natural's crops."""
    return [(name, _sha(crop)) for name, crop in
            eval_natural.load_photo_crops()]


def tile_digests(textures):
    """{file name: sha256 of the tile's bytes} of train_natural build,
    without writing the tiles."""
    return {fname: _sha(tile)
            for name, path, stride in train_natural.sources(textures)
            for fname, tile in train_natural.tiles(name, path, stride)}


def write_tiles(out_dir, names):
    """train_natural's tiles of the given file names, saved as build saves
    them (the textures' too)."""
    os.makedirs(out_dir, exist_ok=True)
    want = set(names)
    for name, path, stride in train_natural.sources(True):
        for fname, tile in train_natural.tiles(name, path, stride):
            if fname in want:
                np.save(os.path.join(out_dir, fname), tile)


def eval_lines(argv):
    """eval_natural's main with --device cpu: the lines it prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        lines = eval_natural.main([*argv, "--device", "cpu"])
    assert out.getvalue().splitlines() == lines
    return lines


def train_run(workdir, argv):
    """train_natural's main(["train", ...]) with --device cpu in
    `workdir`: its stdout's tool lines, the steps run, and whether the
    export was written."""
    old = os.getcwd()
    os.chdir(workdir)
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            state = train_natural.main(["train", *argv, "--device", "cpu"])
        said = [line for line in out.getvalue().splitlines()
                if line.startswith(("natural train:", "export:"))]
        return said, state.step, os.path.exists(
            "models/nat_autoencoder.dgt")
    finally:
        os.chdir(old)


def nlmeans(img01):
    """unit_test.py's --denoiser nlmeans filter."""
    return unit_test.denoise_nlmeans(img01)


class _Recorder:
    def __init__(self, writer):
        self.writer, self.frames = writer, []

    def write(self, frame):
        self.frames.append(np.array(frame, copy=True))
        self.writer.write(frame)

    def release(self):
        self.writer.release()


def mp4_cli(video, out, model):
    """The video CLI on an mp4 with --kernel_tail 1 on the CPU (the tail's
    twin), its writer recorded: the frames it was given, and the FSRGAN
    kernel engine called here on cv2's decoded frames, calibrated as the
    CLI calibrates."""
    import cv2
    recorders = []
    open_writer = video_cli.open_writer

    def recording(*args, **kw):
        recorders.append(_Recorder(open_writer(*args, **kw)))
        return recorders[-1]

    video_cli.open_writer = recording
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            video_cli.main(["--input_video", video, "--output_video", out,
                            "--model", model, "--score", "0",
                            "--kernel_tail", "1", "--device", "cpu"])
    finally:
        video_cli.open_writer = open_writer
    cap = cv2.VideoCapture(video)
    decoded = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        decoded.append(frame)
    cap.release()
    _, net = load_generator(model, device="cpu")
    calib = [torch.from_numpy(f) for f in
             video_cli._peek_calib_frames(video, 0)]
    h, w = decoded[0].shape[:2]
    engine = ke.build_fsrgan_kernel_engine(
        net, h, w, u8_input=True, bgr_input=True, bgr=True,
        q8_calib_frame=calib)
    direct = [engine(torch.from_numpy(f)).numpy() for f in decoded]
    return recorders[0].frames, direct
