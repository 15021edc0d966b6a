"""The port's video CLI on the kernel engine (--kernel_tail 1, FSRGAN 4x,
--device cpu, where the fused tail runs as its plain twin), which the JAX
CLI cannot run on the CPU (its pallas_call has no interpret flag there).
The port runs in a child process (tests/torch_process.py).

- Unscored, the CLI writes the bytes of build_fsrgan_kernel_engine
  called directly on the same frames and calibration: BGR uint8 in, RGB
  out for the RGBA AVI (BGR out for cv2's writer, taken by a recorder),
  w8a8 (--q8 -1) and qh8 (--q8 2, from frame 1), calibrated on the
  frames at the JAX CLI's positions frame_start + (span * k) // 4, k < 4
  (tests/test_torch_cli.py holds _peek_calib_frames to JAX's).  Exact.
  That engine is held against the JAX package's interpret-mode engine by
  tests/test_torch_engine.py and test_torch_engine_modes.py.
- Scored, it takes the f32 RGB frame and scores every 8th frame (frame 0
  of 5): its PSNR and SSIM equal the JAX package's psnr and ssim of the
  frame it wrote against the JAX package's bicubic upscale of the input,
  within 0.05 dB and 1e-3.
Files: tests/serving_files.py (FSRGAN, 5 frames of 100x150).
"""

import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()

import jax.numpy as jnp  # noqa: E402

from denoise_gan_tpu.ops.image import resize_bicubic  # noqa: E402
from denoise_gan_tpu.ops.metrics import psnr, ssim  # noqa: E402
from denoise_gan_tpu_torch.io import avi  # noqa: E402

import serving_files as sf  # noqa: E402

PSNR_DB, SSIM_ABS = 0.05, 1e-3


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return sf.write_files(tmp_path_factory.mktemp("cli"), ("fsrgan",))[
        "fsrgan"]


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_serving") as call:
        yield call


def _argv(files, flags, score, out):
    model, video = files
    return ["--input_video", video, "--model", model, "--score", str(score),
            "--output_video", out, "--kernel_tail", "1", "--device", "cpu",
            *flags]


@pytest.mark.parametrize("q8,frame_start", [(-1, 0), (2, 1)],
                         ids=["w8a8", "qh8-from-1"])
def test_kernel_engine_path_equals_engine(port, files, tmp_path, q8,
                                          frame_start):
    model, video = files
    span = sf.FRAMES - frame_start
    calib_at = sorted({frame_start + span * k // 4 for k in range(4)})
    _, text, got = port("video_cli", _argv(
        files, ["--q8", str(q8), "--frame_start", str(frame_start)], 0,
        str(tmp_path / "k.avi")))
    tail = "w8a8+h8 tail" if q8 == 2 else "w8a8 tail"
    assert f"engine: fused-kernel (fsrgan 4x, {tail}, u8/bgr in; fixed" \
        in text
    want = port("kernel_engine_direct", model, video, frame_start,
                calib_at, qh8=q8 == 2)
    assert got.shape == want.shape == (span, 400, 600, 3)
    np.testing.assert_array_equal(got, want)


def test_kernel_engine_bgr_out_for_cv2(port, files, tmp_path):
    """A non-.avi output: the kernel engine emits BGR bytes for
    cv2.VideoWriter (replaced by a recorder), the frames the AVI holds."""
    model, video = files
    text, got = port("video_cli_cv2", _argv(
        files, ["--max_frames", "2"], 0, str(tmp_path / "k.mp4")))
    assert "engine: fused-kernel (fsrgan 4x, w8a8 tail, u8/bgr in, bgr " \
        "out; fixed" in text
    want = port("kernel_engine_direct", model, video, 0, [0, 1, 2, 3])
    assert got.shape == (2, 400, 600, 3)
    np.testing.assert_array_equal(got, want[:2])


def test_kernel_engine_scores_every_8th_frame(port, files, tmp_path):
    model, video = files
    got, text, frames = port("video_cli", _argv(files, [], 1,
                                                str(tmp_path / "k.avi")))
    assert "fused-kernel (fsrgan 4x, w8a8 tail; fixed" in text
    assert "scoring every 8th frame" in text and got["scored_frames"] == 1
    r = avi.VideoReader(video)
    x = r.read()[1][..., ::-1].astype(np.float32) / 255.0
    r.release()
    ref = jnp.clip(resize_bicubic(jnp.asarray(x)[None], 400, 600), 0, 1)
    out = jnp.asarray(frames[0][..., ::-1].astype(np.float32) / 255.0)[None]
    want_p, want_s = float(psnr(out, ref)[0]), float(ssim(out, ref)[0])
    print(f"psnr {got['psnr']:.4f} vs {want_p:.4f}, ssim {got['ssim']:.5f} "
          f"vs {want_s:.5f}")
    assert abs(got["psnr"] - want_p) < PSNR_DB
    assert abs(got["ssim"] - want_s) < SSIM_ABS
