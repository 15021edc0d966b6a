"""The port's uncompressed RGBA AVI (denoise_gan_tpu_torch/io/avi.py)
against cv2, which the JAX package's video CLI reads and writes with.
io/avi.py imports numpy only, so it runs in the test process; the
container choice of the video CLI (infer/video.py::open_video,
open_writer) runs in a child process (tests/torch_process.py).

- A file of cv2.VideoWriter with fourcc RGBA is read by the port
  bit-exact (equal to cv2's own read; cv2's writer cuts odd sizes to even
  ones, and both readers see that).
- A file of the port's writer is read by cv2 bit-exact, at an odd size
  (45x67) and an even one, in one RIFF part and in several OpenDML parts.
- Frame count, fps, size and fourcc; reads in order, by index and past
  the end.
- A compressed AVI is refused by the port's reader, and without cv2 the
  CLI's reader and a non-.avi writer raise an error that names the
  supported form.
"""

import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()
cv2 = pytest.importorskip("cv2")

from denoise_gan_tpu_torch.io import avi  # noqa: E402

FRAMES = 5


def _frames(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((h, w, 3)) * 255).astype(np.uint8)
            for _ in range(FRAMES)]


def _cv2_read(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames


def _port_read(path):
    r = avi.VideoReader(path)
    frames = [r.read()[1] for _ in range(r.frame_count)]
    assert r.read() == (False, None)
    r.release()
    return frames


@pytest.mark.parametrize("h,w", [(48, 64), (45, 67)])
def test_port_reads_cv2_rgba(tmp_path, h, w):
    path = str(tmp_path / "cv2.avi")
    frames = _frames(h, w)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"RGBA"), 12.5, (w, h))
    for f in frames:
        vw.write(f)
    vw.release()
    want = _cv2_read(path)
    got = _port_read(path)
    assert len(got) == len(want) == FRAMES
    for g, c, f in zip(got, want, frames):
        np.testing.assert_array_equal(g, c)
        np.testing.assert_array_equal(g, f[:g.shape[0], :g.shape[1]])


@pytest.mark.parametrize("h,w,riff_bytes", [
    (45, 67, avi.RIFF_BYTES), (48, 64, avi.RIFF_BYTES), (45, 67, 30_000)],
    ids=["odd", "even", "odd-opendml"])
def test_cv2_reads_port_avi(tmp_path, h, w, riff_bytes):
    """riff_bytes 30,000 puts two 12,060-byte frames in each RIFF part:
    an AVI part, then AVIX parts, found through the super index."""
    path = str(tmp_path / "port.avi")
    frames = _frames(h, w, seed=1)
    vw = avi.VideoWriter(path, 29.97, (w, h), riff_bytes=riff_bytes)
    for f in frames:
        vw.write(f)
    vw.release()
    cap = cv2.VideoCapture(path)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == FRAMES
    assert cap.get(cv2.CAP_PROP_FPS) == pytest.approx(29.97, rel=1e-6)
    cap.release()
    for reader in (_cv2_read, _port_read):
        got = reader(path)
        assert len(got) == FRAMES
        for g, f in zip(got, frames):
            np.testing.assert_array_equal(g, f)


def test_writer_refuses_a_part_past_the_super_index(tmp_path, monkeypatch):
    """With room for 2 parts of 2 frames, the fifth frame would open a
    third part: it raises, and the file released after it holds the four
    frames before it, read alike by cv2 and the port."""
    monkeypatch.setattr(avi, "SUPER_ENTRIES", 2)
    path = str(tmp_path / "full.avi")
    frames = _frames(45, 67, seed=3)
    vw = avi.VideoWriter(path, 25, (67, 45), riff_bytes=30_000)
    for f in frames[:4]:
        vw.write(f)
    with pytest.raises(ValueError, match="super index holds 2 parts"):
        vw.write(frames[4])
    vw.release()
    for reader in (_cv2_read, _port_read):
        got = reader(path)
        assert len(got) == 4
        for g, f in zip(got, frames):
            np.testing.assert_array_equal(g, f)


def test_info_and_reads_by_index(tmp_path):
    path = str(tmp_path / "port.avi")
    frames = _frames(45, 67, seed=2)
    vw = avi.VideoWriter(path, 12.5, (67, 45))
    for f in frames:
        vw.write(f)
    vw.release()
    r = avi.VideoReader(path)
    assert (r.frame_count, r.fps, r.width, r.height) == (FRAMES, 12.5, 67,
                                                         45)
    assert avi.decode_fourcc(r.fourcc) == "RGBA"
    for i in (3, 0, 4, 1):
        r.seek(i)
        ok, f = r.read()
        assert ok
        np.testing.assert_array_equal(f, frames[i])
    np.testing.assert_array_equal(r.read()[1], frames[2])
    r.seek(FRAMES)
    assert r.read() == (False, None)
    r.release()
    vw = avi.VideoWriter(str(tmp_path / "x.avi"), 25, (67, 45))
    with pytest.raises(ValueError, match="uint8"):
        vw.write(frames[0][:-1])
    vw.release()


def test_compressed_avi_refused_without_cv2(tmp_path):
    path = str(tmp_path / "mjpg.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25, (64, 48))
    for f in _frames(48, 64):
        vw.write(f)
    vw.release()
    with pytest.raises(avi.UnsupportedVideo, match="only uncompressed RGBA"):
        avi.VideoReader(path)
    with torch_process("torch_side_serving") as port:
        message = port("without_cv2", "read", path)
        assert "only uncompressed RGBA" in message and \
            "fourcc 'RGBA'" in message
        message = port("without_cv2", "write", str(tmp_path / "out.mp4"))
        assert "needs cv2" in message and "fourcc 'RGBA'" in message
