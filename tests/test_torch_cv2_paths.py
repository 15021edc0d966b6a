"""The port's paths through cv2, on the CPU: unit_test.py's ``--denoiser
nlmeans`` (cv2.fastNlMeansDenoisingColored) equal to the JAX package's
filter (the repository root's unit_test.py) on a seeded image; and the
video CLI (infer/video.py) on an mp4 that cv2 wrote, through the FSRGAN
kernel engine (``--kernel_tail 1``, the tail's twin on the CPU) to an
mp4 that cv2 reads back, its frames before encoding equal to the engine
called on cv2's decoded frames.  chip_smoke.py's phase 4n runs both on
the card.  The port runs in a child process (tests/torch_process.py,
tests/torch_side_natural.py).
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()
cv2 = pytest.importorskip("cv2")

from denoise_gan_tpu.io import checkpoint as jck  # noqa: E402

import serving_files as sf  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
H, W, FRAMES = 48, 64, 3


def _jax_unit_test():
    saved = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_unit_test", REPO / "unit_test.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_natural") as call:
        yield call


@pytest.mark.parametrize("seed", [0, 1])
def test_nlmeans_equals_jax_filter(port, seed):
    img = np.random.default_rng(seed).random((64, 80, 3)).astype(np.float32)
    got = port("nlmeans", img)
    want = _jax_unit_test().denoise_nlmeans(img)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_video_cli_on_mp4(port, tmp_path):
    rng = np.random.default_rng(3)
    params, stats = (sf.draw(t, rng) for t in sf.shapes("fsrgan"))
    model = str(tmp_path / "fsrgan.dgt")
    jck.export_generator(model, "fsrgan", 4, params, stats)
    video, out = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 25.0,
                             (W, H))
    yy, xx = np.mgrid[0:H, 0:W]
    for i in range(FRAMES):
        f = (127 + 100 * np.sin((xx + 4 * i) / 7.0 + yy / 9.0))[..., None]
        writer.write(np.repeat(f, 3, axis=2).astype(np.uint8))
    writer.release()
    recorded, direct = port("mp4_cli", video, out, model)
    assert len(recorded) == len(direct) == FRAMES
    for g, w in zip(recorded, direct):
        assert g.shape == (4 * H, 4 * W, 3)
        np.testing.assert_array_equal(g, w)
    cap = cv2.VideoCapture(out)
    shapes = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        shapes.append(frame.shape)
    cap.release()
    assert shapes == [(4 * H, 4 * W, 3)] * FRAMES
