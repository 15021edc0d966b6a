"""The port's image codec (denoise_gan_tpu_torch/data/native.py: native/
imgcodec.cpp and data/png.py) against the JAX package's libjpeg/libpng
binding (denoise_gan_tpu/data/native.py), byte for byte, on the CPU.  The
port runs in a child process (tests/torch_process.py, tests/
torch_side_codec.py).

- Every fixture of tests/data/codec/ (written by tests/
  make_codec_fixtures.py with cv2, PIL and numpy + zlib: baseline JPEG at
  4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1 at qualities 1-95, progressive
  with and without optimised tables, restart intervals, gray, sizes 1x1 to
  129x255; PNG of every colour type and depth, palettes shorter than
  2^depth, Adam7) decodes equal to the JAX binding's decode, whose sha256
  the sidecar holds for the card.  So do the files libjpeg and libpng read
  in part or refuse: JPEGs cut or with a marker inside a scan (baseline,
  extended, progressive, arithmetic), bad Huffman codes, restart markers
  out of sequence, progressive scans out of order or left incomplete
  (block smoothing), arithmetic coding (tests/make_arith_jpeg.cpp); PNGs
  with a bad Adler-32, an unended stream, extra data, no IEND, bad CRCs
  after the image; garbage, cut headers, a critical chunk's bad CRC and
  CMYK (None, as the binding gives).
- jpeg_roundtrip_u8 equals the JAX binding's at nine qualities 1-100 and
  seven sizes (1x1, 1x17, 17x1, 7x13, 37x53, 64x64, 129x255).
- A JPEG the port writes is read by libjpeg as the port's round trip at
  its quality, and by cv2 and PIL; at cv2.imwrite's defaults the port
  writes cv2's bytes.  A PNG the port writes decodes back exactly.
- decode_image reads image files with the port's codec, raises an IOError
  for a JPEG or PNG file it refuses, and sends other formats to cv2; the
  codec's source needs no library.
"""

import hashlib
import json
import re
from pathlib import Path

import numpy as np
import pytest

from torch_process import skip_without_torch, torch_process

skip_without_torch()
cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from denoise_gan_tpu.data import native as jnative  # noqa: E402
from denoise_gan_tpu.data.pipeline import decode_image  # noqa: E402

import make_codec_fixtures as mcf  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SIDECAR = json.loads(mcf.SIDECAR.read_text())
FILES = sorted(SIDECAR["files"])
WRITE_QUALITIES = (1, 50, 95, 100)
WRITE_SIZES = ((1, 1), (7, 13), (37, 53))


def _path(name: str) -> str:
    return str(mcf.OUT / name)


@pytest.fixture(scope="module")
def jax_codec():
    if not jnative.available():
        pytest.skip("the JAX binding's libjpeg/libpng codec is unavailable")
    return jnative


@pytest.fixture(scope="module")
def port():
    with torch_process("torch_side_codec") as call:
        yield call


@pytest.fixture(scope="module")
def decoded(port):
    return dict(zip(FILES, port("decode_files", [_path(n) for n in FILES])))


@pytest.fixture(scope="module")
def rt_images():
    return [mcf.seeded_image(h, w, SIDECAR["roundtrip_seed"])
            for h, w in mcf.RT_SIZES]


@pytest.fixture(scope="module")
def port_roundtrips(port, rt_images):
    return port("roundtrips", rt_images, list(mcf.RT_QUALITIES))


@pytest.mark.parametrize("name", FILES)
def test_fixture_decodes_as_libjpeg_libpng(decoded, jax_codec, name):
    want = jax_codec.decode(_path(name))
    assert mcf.digest(want) == SIDECAR["files"][name]["sha256"]
    got = decoded[name]
    if want is None:
        assert got is None
        return
    assert got is not None
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qi", range(len(mcf.RT_QUALITIES)),
                         ids=[f"q{q}" for q in mcf.RT_QUALITIES])
def test_roundtrip_equals_libjpeg(port_roundtrips, rt_images, jax_codec, qi):
    q = mcf.RT_QUALITIES[qi]
    for (h, w), img, got in zip(mcf.RT_SIZES, rt_images, port_roundtrips):
        want = jax_codec.jpeg_roundtrip_u8(img, q)
        assert mcf.digest(want) == SIDECAR["roundtrip"][
            mcf.roundtrip_key(h, w, q)]
        assert got[qi] is not None, (h, w, q)
        np.testing.assert_array_equal(got[qi], want, err_msg=f"{h}x{w}")


def test_port_jpeg_reads_in_libjpeg_as_its_roundtrip(port, jax_codec,
                                                     tmp_path):
    cases, images = [], {}
    for h, w in WRITE_SIZES:
        images[(h, w)] = mcf.seeded_image(h, w, 30 + h)
        for q in WRITE_QUALITIES:
            cases.append((str(tmp_path / f"{h}x{w}_q{q}.jpg"),
                          images[(h, w)], q))
    port("encode_files", cases)
    trips = port("roundtrips", list(images.values()), list(WRITE_QUALITIES))
    for i, (h, w) in enumerate(WRITE_SIZES):
        for j, q in enumerate(WRITE_QUALITIES):
            path = str(tmp_path / f"{h}x{w}_q{q}.jpg")
            np.testing.assert_array_equal(jax_codec.decode(path), trips[i][j])
            assert cv2.imread(path).shape == (h, w, 3)
            with Image.open(path) as im:
                assert im.size == (w, h) and im.mode == "RGB"


def test_port_jpeg_is_cv2_imwrite_default(port, jax_codec, tmp_path):
    """save_image_bgr's .jpg and .jpeg: the bytes (and so the decode) of
    cv2.imwrite at its defaults, quality 95 and 4:2:0."""
    cases = []
    for i, (h, w) in enumerate(((1, 1), (37, 53), (64, 64), (129, 255))):
        rgb01 = np.random.default_rng(50 + i).random((h, w, 3)).astype(
            np.float32)
        suffix = ".jpeg" if i % 2 else ".jpg"
        cases.append((str(tmp_path / f"port{i}{suffix}"), rgb01))
    port("save_images", cases)
    for i, (path, rgb01) in enumerate(cases):
        u8 = np.clip(rgb01 * 255.0, 0, 255).astype(np.uint8)
        ref = str(tmp_path / f"cv2_{i}.jpg")
        cv2.imwrite(ref, u8[..., ::-1])
        np.testing.assert_array_equal(jax_codec.decode(path),
                                      jax_codec.decode(ref))
        assert Path(path).read_bytes() == Path(ref).read_bytes()


def test_port_png_decodes_back_exactly(port, tmp_path):
    cases = [(str(tmp_path / f"p{h}x{w}.png"),
              mcf.seeded_image(h, w, 60 + h), 95)
             for h, w in ((1, 1), (1, 17), (37, 53))]
    port("encode_files", cases)
    back = port("decode_files", [c[0] for c in cases])
    for (path, rgb, _), got in zip(cases, back):
        np.testing.assert_array_equal(got, rgb)
        np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], rgb)
        with Image.open(path) as im:
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")), rgb)


def test_decode_image_reads_by_the_port_codec(port):
    names = ["base_420_q75.jpg", "prog_q30.jpg", "own_c0_d2_i1.png",
             "pil_palette_trns.png"]
    decoder, images = port("decode_images", [_path(n) for n in names])
    assert decoder == "native"
    for name, img in zip(names, images):
        assert img.dtype == np.float32
        np.testing.assert_array_equal(img, decode_image(_path(name)))


def test_decode_image_passes_no_refused_file_on(port, decoded, tmp_path):
    """A JPEG or PNG file the codec refuses raises an IOError that names
    it, and goes to no other decoder (cv2 and PIL read the CMYK JPEG); a
    file of another format (BMP) goes on to cv2."""
    refused = [n for n in FILES if decoded[n] is None]
    assert {"bad_truncated.jpg", "bad_cmyk.jpg", "bad_crc.png"} <= set(
        refused)
    assert cv2.imread(_path("bad_cmyk.jpg")) is not None
    img = mcf.seeded_image(5, 7, 9)
    bmp = str(tmp_path / "a.bmp")
    cv2.imwrite(bmp, img[..., ::-1])
    results = port("decode_image_results",
                   [_path(n) for n in refused] + [bmp])
    for name, (err, got) in zip(refused, results):
        assert got is None and err is not None and name in err
    err, got = results[-1]
    assert err is None
    np.testing.assert_array_equal(got, img.astype(np.float32) / 255.0)


def test_codec_refuses_what_is_not_rgb(port, tmp_path):
    """Shapes are checked before a pointer reaches the C++; a suffix the
    codec does not write is refused, not sent to another encoder."""
    gray, rgba, bmp = port("refused_calls", str(tmp_path))
    assert "(4, 4)" in gray and "(4, 4, 4)" in rgba and "a.bmp" in bmp
    assert not list(tmp_path.iterdir())


def test_codec_source_needs_no_library():
    """g++ and the standard library: no libjpeg, libpng or zlib header,
    no -l flag, and nothing of the repository's native/ directory."""
    src = REPO / "denoise_gan_tpu_torch" / "native" / "imgcodec.cpp"
    includes = re.findall(r"#include\s*[<\"]([^>\"]+)", src.read_text())
    assert includes and not {"jpeglib.h", "png.h", "zlib.h"} & set(includes)
    text = (REPO / "denoise_gan_tpu_torch" / "data" / "native.py"
            ).read_text()
    flags = re.search(r"^FLAGS = (\[.*\])$", text, re.M).group(1)
    assert "-l" not in flags and "imgcodec.cpp" in text
    assert 'parents[2] / "native"' not in text


def test_fixtures_fit_their_budget():
    total = sum(p.stat().st_size for p in mcf.OUT.iterdir())
    assert total < 300_000 and len(FILES) == len(list(mcf.OUT.glob("*"))) - 1
    hashes = [v["sha256"] for v in SIDECAR["files"].values()]
    assert all(h is None or len(h) == len(hashlib.sha256().hexdigest())
               for h in hashes)
