"""The port's video CLI (denoise_gan_tpu_torch/infer/video.py) against
the JAX package's (denoise_gan_tpu/infer/video.py) on the same RGBA AVI
and the same ``.dgt`` exports.  The port runs in a child process
(tests/torch_process.py) with ``--device cpu``; the JAX CLI reads the
file through cv2, and its written frames are taken from a recorder put in
place of cv2.VideoWriter in this process.

Files (tests/serving_files.py): 5 frames of 48x64 (the autoencoder, 1x)
and of 100x150 (FSRGAN 4x); weights drawn with numpy.  The JAX CLI's
load_generator is serving_files.load_generator (the same trees without
the eager Flax init).

Paths the JAX CLI runs on the CPU, each unscored and scored:
- whole frame (--tile 0 --fast 0) and plain tiled (--fast 0), f32: the
  written frames max 1 level apart on < 1e-3 of the bytes;
- the 1x crop engine and the 4x coarse engine (--kernel_tail 0), bf16:
  max 2 levels, > 1 on < 5e-3 and > 0 on < 5% of the bytes (measured:
  crop max 2, > 1 on 2.7e-3, > 0 on 3.9%; coarse 2, 2.2e-3, 1.6%).  The
  generators' bf16 outputs differ by an ulp here and there (PyTorch and
  XLA sum in other orders), and in [0.5, 1) a bf16 ulp is one u8 level,
  so the engine's bf16 (x + 1) / 2 and x * 255 + 0.5 can take one ulp to
  two levels; both packages round those steps alike on the same input.
  PERF.md section 2's bf16 envelope (max 1 on < 5%) was read on single
  tiles and does not hold over these frames;
- PSNR within 0.05 dB and SSIM within 1e-3 of JAX's.
Also: the engine choice's notes and auto geometry, and
_peek_calib_frames, which reads the same frames at the same positions as
JAX's.  The kernel-engine path is tests/test_torch_cli_kernel.py's.
"""

import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()
cv2 = pytest.importorskip("cv2")

from denoise_gan_tpu.infer import image as jimage  # noqa: E402
from denoise_gan_tpu.infer import video as jvideo  # noqa: E402
from denoise_gan_tpu.io import checkpoint as jck  # noqa: E402

import serving_files as sf  # noqa: E402

# (max levels, share > 1 level, share > 0) of the written frames
F32, BF16 = (1, 0.0, 1e-3), (2, 5e-3, 5e-2)
PSNR_DB, SSIM_ABS = 0.05, 1e-3

# (id, family, CLI flags, envelope)
PATHS = [
    ("whole", "autoencoder", ["--tile", "0", "--fast", "0"], F32),
    ("tiled", "autoencoder", ["--tile", "32", "--tile_overlap", "8",
                              "--fast", "0"], F32),
    ("crop", "autoencoder", ["--tile", "32", "--tile_overlap", "8"], BF16),
    ("coarse", "fsrgan", ["--kernel_tail", "0", "--tile", "64",
                          "--tile_overlap", "4"], BF16),
]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return sf.write_files(tmp_path_factory.mktemp("cli"))


class _Recorder:
    """Stands in for cv2.VideoWriter in the JAX CLI: keeps the frames."""
    frames: list = []

    def __init__(self, *args, **kwargs):
        _Recorder.frames = []

    def write(self, frame):
        _Recorder.frames.append(np.array(frame))

    def release(self):
        pass


@pytest.fixture
def jax_cli(monkeypatch):
    """run(argv) -> (result, written BGR frames) of the JAX video CLI."""
    monkeypatch.setattr(cv2, "VideoWriter", _Recorder)
    monkeypatch.setattr(jimage, "load_generator", sf.load_generator)
    monkeypatch.setattr(jck, "load_generator", sf.load_generator)

    def run(argv):
        result = jvideo.process_video(jvideo.build_parser().parse_args(argv))
        return result, np.stack(_Recorder.frames)

    return run


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_serving") as call:
        yield call


def _argv(files, family, flags, score, out):
    model, video = files[family]
    return ["--input_video", video, "--model", model, "--score", str(score),
            "--output_video", out, *flags]


@pytest.mark.parametrize("score", [0, 1], ids=["unscored", "scored"])
@pytest.mark.parametrize("name,family,flags,bound", PATHS,
                         ids=[p[0] for p in PATHS])
def test_video_cli_matches_jax(port, jax_cli, files, tmp_path, name, family,
                               flags, bound, score):
    want, want_frames = jax_cli(_argv(files, family, flags, score,
                                      str(tmp_path / "jax.mp4")))
    got, text, got_frames = port("video_cli", _argv(
        files, family, flags, score, str(tmp_path / "port.avi")) +
        ["--device", "cpu"])
    assert "engine:" in text and f"processed {sf.FRAMES} frames" in text
    assert got["frames"] == want["frames"] == sf.FRAMES
    sf.envelope(f"{name} score={score}", got_frames, want_frames, bound)
    assert got["scored_frames"] == want["scored_frames"]
    if score:
        print(f"  psnr {got['psnr']:.4f} vs {want['psnr']:.4f}, ssim "
              f"{got['ssim']:.5f} vs {want['ssim']:.5f}")
        assert abs(got["psnr"] - want["psnr"]) < PSNR_DB
        assert abs(got["ssim"] - want["ssim"]) < SSIM_ABS
    else:
        assert got["psnr"] is None and want["psnr"] is None


def test_engine_choice_notes(port, files, tmp_path):
    """The auto tile geometry (autoencoder 128/8), the --kernel_tail 1
    note on a 1x family, and the upscaler's kernel engine off by default on
    the CPU (the coarse engine at FSRGAN's 144/4)."""
    _, text, _ = port("video_cli", _argv(
        files, "autoencoder", ["--kernel_tail", "1", "--max_frames", "1"], 0,
        str(tmp_path / "a.avi")) + ["--device", "cpu"])
    assert "engine: torch-crop (128/8); scoring off" in text
    assert "--kernel_tail 1 ignored" in text
    _, text, frames = port("video_cli", _argv(
        files, "fsrgan", ["--max_frames", "1"], 0,
        str(tmp_path / "f.avi")) + ["--device", "cpu"])
    assert "engine: torch-crop coarse (144/4)" in text
    assert frames.shape == (1, 400, 600, 3)


@pytest.mark.parametrize("name,family,flags,engine", [
    ("crop", "autoencoder", PATHS[2][2], "torch-crop (32/8), bgr out"),
    ("coarse", "fsrgan", PATHS[3][2], "torch-crop coarse (64/4);")],
    ids=["crop", "coarse"])
def test_cv2_writer_gets_the_avi_frames(port, files, tmp_path, name, family,
                                        flags, engine):
    """A non-.avi output goes to cv2.VideoWriter as BGR: the 1x crop
    engine emits BGR itself, the coarse engine's RGB is flipped on the
    device.  Its frames equal the RGBA AVI's read back as BGR (for the
    AVI the engines emit RGB), byte for byte."""
    flags = [*flags, "--max_frames", "2", "--device", "cpu"]
    _, text, want = port("video_cli", _argv(files, family, flags, 0,
                                            str(tmp_path / "o.avi")))
    assert "bgr out" not in text
    text, got = port("video_cli_cv2", _argv(files, family, flags, 0,
                                            str(tmp_path / "o.mp4")))
    assert f"engine: {engine}" in text
    assert got.shape == want.shape and got.shape[0] == 2
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frame_start", [0, 2])
def test_peek_calib_frames_match_jax(port, files, frame_start):
    video = files["fsrgan"][1]
    want = jvideo._peek_calib_frames(video, frame_start)
    got = port("peek_calib", video, frame_start)
    assert len(got) == len(want) == (4 if frame_start == 0 else 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
