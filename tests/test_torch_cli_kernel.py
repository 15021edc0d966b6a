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
Files: tests/serving_files.py (FSRGAN, 5 frames of 100x150).  Every run of
the port is started at once in three child processes; the direct engine
run that two tests compare with is made once.
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
    with torch_process("torch_side_serving", workers=3) as call:
        yield call


def _argv(files, flags, score, out):
    model, video = files
    return ["--input_video", video, "--model", model, "--score", str(score),
            "--output_video", out, "--kernel_tail", "1", "--device", "cpu",
            *flags]


# (q8, frame_start) of the unscored AVI cases
UNSCORED = [(-1, 0), (2, 1)]


def _calib_at(frame_start):
    """The JAX CLI's calibration frames from `frame_start`."""
    span = sf.FRAMES - frame_start
    return sorted({frame_start + span * k // 4 for k in range(4)})


@pytest.fixture(scope="module")
def started(port, files, tmp_path_factory):
    """The port's runs, started in the children at once, in the order the
    tests read them: {case: future}.  ("direct", -1, 0), w8a8 from frame
    0, is the engine both the w8a8 AVI and the cv2 output are held to."""
    out_dir = tmp_path_factory.mktemp("port_out")
    model, video = files
    runs = {}
    for q8, start in UNSCORED:
        runs[("cli", q8, start)] = port.submit("video_cli", _argv(
            files, ["--q8", str(q8), "--frame_start", str(start)], 0,
            str(out_dir / f"k{q8}_{start}.avi")))
        runs[("direct", q8, start)] = port.submit(
            "kernel_engine_direct", model, video, start, _calib_at(start),
            qh8=q8 == 2)
    runs["cv2"] = port.submit("video_cli_cv2", _argv(
        files, ["--max_frames", "2"], 0, str(out_dir / "k.mp4")))
    runs["scored"] = port.submit("video_cli", _argv(
        files, [], 1, str(out_dir / "scored.avi")))
    return runs


@pytest.mark.parametrize("q8,frame_start", UNSCORED,
                         ids=["w8a8", "qh8-from-1"])
def test_kernel_engine_path_equals_engine(started, q8, frame_start):
    span = sf.FRAMES - frame_start
    _, text, got = started[("cli", q8, frame_start)].result()
    tail = "w8a8+h8 tail" if q8 == 2 else "w8a8 tail"
    assert f"engine: fused-kernel (fsrgan 4x, {tail}, u8/bgr in; fixed" \
        in text
    want = started[("direct", q8, frame_start)].result()
    assert got.shape == want.shape == (span, 400, 600, 3)
    np.testing.assert_array_equal(got, want)


def test_kernel_engine_bgr_out_for_cv2(started):
    """A non-.avi output: the kernel engine emits BGR bytes for
    cv2.VideoWriter (replaced by a recorder), the frames the AVI holds."""
    assert _calib_at(0) == [0, 1, 2, 3]
    text, got = started["cv2"].result()
    assert "engine: fused-kernel (fsrgan 4x, w8a8 tail, u8/bgr in, bgr " \
        "out; fixed" in text
    want = started[("direct", -1, 0)].result()
    assert got.shape == (2, 400, 600, 3)
    np.testing.assert_array_equal(got, want[:2])


def test_kernel_engine_scores_every_8th_frame(started, files):
    _, video = files
    got, text, frames = started["scored"].result()
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
