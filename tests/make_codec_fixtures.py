"""Write the image-codec fixtures of tests/test_torch_codec.py into
tests/data/codec/, with the JSON sidecar ``codec.json`` that holds the
sha256 of the JAX package's libjpeg/libpng decode of each file
(denoise_gan_tpu/data/native.py; null where it refuses the file) and of
its exact JPEG round trip of seeded images, so that a machine without
libjpeg (the card's) checks the port's codec against the same bytes.

JPEGs are written by cv2 and PIL (libjpeg-turbo), PNGs by PIL, cv2 and
this script's own numpy + zlib writer (the depths and colour types PIL
does not write, Adam7, palettes shorter than 2^depth with indices
past their end, a palette longer than 2^depth, every row filter).
Needs cv2, PIL and the JAX binding's libjpeg/libpng build; run once:

    python tests/make_codec_fixtures.py
"""

from __future__ import annotations

import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

from codec_seeds import digest, roundtrip_key, seeded_image

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "data" / "codec"
SIDECAR = OUT / "codec.json"
# the round trip's seeded images and qualities
RT_SIZES = ((1, 1), (1, 17), (17, 1), (7, 13), (37, 53), (64, 64),
            (129, 255))
RT_QUALITIES = (1, 5, 10, 25, 50, 75, 90, 95, 100)
RT_SEED = 20
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


# ------------------------------------------------------------ PNG writer
def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(rows, n) samples -> packed bytes per row, big-endian bit order."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(len(samples), -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    rows, n = samples.shape
    out = np.zeros((rows, (n + per - 1) // per), np.uint8)
    for i in range(n):
        shift = 8 - depth - (i % per) * depth
        out[:, i // per] |= (samples[:, i] << shift).astype(np.uint8)
    return out


def _filter(rows: np.ndarray, bpp: int, kinds) -> bytes:
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for r, f in zip(rows.astype(np.int32), kinds):
        shifted = lambda a: np.concatenate(  # noqa: E731
            [np.zeros(bpp, np.int32), a[:-bpp]])[:len(a)]
        left, up_left = shifted(r), shifted(prev)
        if f == 0:
            x = r
        elif f == 1:
            x = r - left
        elif f == 2:
            x = r - prev
        elif f == 3:
            x = r - (left + prev) // 2
        else:
            p = left + prev - up_left
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - up_left)
            x = r - np.where((pa <= pb) & (pa <= pc), left,
                             np.where(pb <= pc, prev, up_left))
        out.append(bytes([int(f)]) + (x & 255).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def write_png(path: Path, samples: np.ndarray, depth: int, color: int,
              interlace: int = 0, plte=None, trns: bytes | None = None,
              seed: int = 0) -> None:
    """samples (h, w, channels) of `depth` bits, each row with a filter
    drawn from the five; Adam7 when `interlace`."""
    rng = np.random.default_rng(seed)
    h, w, ch = samples.shape
    bpp = max(1, depth * ch // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub.reshape(sub.shape[0], -1), depth)
        raw += _filter(rows, bpp, rng.integers(0, 5, len(rows)))
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if plte is not None:
        data += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    data += _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
    path.write_bytes(data)


# ------------------------------------------------------------ the files
def write_fixtures() -> list[str]:
    import cv2
    from PIL import Image

    OUT.mkdir(parents=True, exist_ok=True)
    for old in OUT.iterdir():
        old.unlink()
    names = []

    def cv2_jpeg(name, rgb, *params):
        cv2.imwrite(str(OUT / name), rgb[..., ::-1], list(params))
        names.append(name)

    img = seeded_image(37, 53, 1)
    sampling = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
    for tag, factor in sampling.items():
        for q in (1, 10, 75, 95):
            cv2_jpeg(f"base_{tag}_q{q}.jpg", img, cv2.IMWRITE_JPEG_QUALITY,
                     q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor)
    big = seeded_image(129, 255, 2)
    for q in (30, 90):
        cv2_jpeg(f"prog_q{q}.jpg", big, cv2.IMWRITE_JPEG_QUALITY, q,
                 cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
        cv2_jpeg(f"prog_opt_q{q}.jpg", big, cv2.IMWRITE_JPEG_QUALITY, q,
                 cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_OPTIMIZE, 1)
    Image.fromarray(img).save(OUT / "prog_pil_444.jpg", quality=80,
                              progressive=True, optimize=True, subsampling=0)
    names.append("prog_pil_444.jpg")
    cv2_jpeg("rst1_q75.jpg", img, cv2.IMWRITE_JPEG_QUALITY, 75,
             cv2.IMWRITE_JPEG_RST_INTERVAL, 1)
    cv2_jpeg("rst3_prog_q75.jpg", big, cv2.IMWRITE_JPEG_QUALITY, 75,
             cv2.IMWRITE_JPEG_RST_INTERVAL, 3, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    cv2.imwrite(str(OUT / "gray_q75.jpg"), gray, [cv2.IMWRITE_JPEG_QUALITY, 75])
    cv2.imwrite(str(OUT / "gray_prog_q50.jpg"), gray,
                [cv2.IMWRITE_JPEG_QUALITY, 50, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    names += ["gray_q75.jpg", "gray_prog_q50.jpg"]
    for h, w in ((1, 1), (1, 17), (17, 1), (7, 13), (37, 53), (129, 255)):
        sized = seeded_image(h, w, 3 + h)
        cv2_jpeg(f"size_{h}x{w}.jpg", sized, cv2.IMWRITE_JPEG_QUALITY, 85)
        Image.fromarray(sized // 16 * 16).save(OUT / f"size_{h}x{w}.png")
        names.append(f"size_{h}x{w}.png")

    # PNG: PIL's and cv2's, then the depths and types they do not write
    rng = np.random.default_rng(5)
    rgba = np.concatenate([img, rng.integers(0, 256, (37, 53, 1),
                                             dtype=np.uint8)], axis=2)
    for mode, arr in (("RGB", img), ("RGBA", rgba), ("L", gray),
                      ("LA", rgba[..., [0, 3]])):
        Image.fromarray(arr, mode).save(OUT / f"pil_{mode.lower()}8.png")
        names.append(f"pil_{mode.lower()}8.png")
    Image.fromarray(img).convert("P").save(OUT / "pil_palette_trns.png",
                                           transparency=3)
    cv2.imwrite(str(OUT / "cv2_rgb16.png"),
                rng.integers(0, 65536, (37, 53, 3)).astype(np.uint16))
    cv2.imwrite(str(OUT / "cv2_gray16.png"),
                rng.integers(0, 65536, (37, 53)).astype(np.uint16))
    names += ["pil_palette_trns.png", "cv2_rgb16.png", "cv2_gray16.png"]
    channels = {0: 1, 2: 3, 4: 2, 6: 4}
    for color, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (4, (8, 16)),
                          (6, (8, 16))):
        for depth in depths:
            for interlace in (0, 1):
                s = rng.integers(0, 1 << depth, (13, 19, channels[color]))
                name = f"own_c{color}_d{depth}_i{interlace}.png"
                write_png(OUT / name, s, depth, color, interlace,
                          seed=color * 100 + depth)
                names.append(name)
    for depth, n in ((1, 2), (2, 3), (4, 5), (8, 40)):
        for interlace in (0, 1):
            s = rng.integers(0, n, (13, 19, 1))
            name = f"own_palette_d{depth}_n{n}_i{interlace}.png"
            write_png(OUT / name, s, depth, 3, interlace,
                      plte=rng.integers(0, 256, (n, 3)),
                      trns=bytes(rng.integers(0, 256, min(n, 4)).astype(
                          np.uint8)), seed=depth)
            names.append(name)
    # indices past a short palette (libpng reads their zero-filled
    # entries) and a PLTE longer than 2^depth (truncated to 2^depth)
    extra = np.random.default_rng(6)
    for interlace in (0, 1):
        name = f"own_palette_d4_n5_over_i{interlace}.png"
        write_png(OUT / name, extra.integers(0, 16, (13, 19, 1)), 4, 3,
                  interlace, plte=extra.integers(0, 256, (5, 3)),
                  trns=bytes([7, 200]), seed=40 + interlace)
        names.append(name)
    write_png(OUT / "own_palette_d2_n9_long.png",
              extra.integers(0, 4, (13, 19, 1)), 2, 3,
              plte=extra.integers(0, 256, (9, 3)), trns=bytes([9, 99, 250]),
              seed=42)
    names.append("own_palette_d2_n9_long.png")
    write_png(OUT / "own_adam7_1x1.png", rng.integers(0, 256, (1, 1, 3)), 8,
              2, 1)
    write_png(OUT / "own_adam7_3x2.png", rng.integers(0, 256, (3, 2, 3)), 8,
              2, 1)
    names += ["own_adam7_1x1.png", "own_adam7_3x2.png"]

    # files the codecs refuse (or libjpeg reads in part)
    jpeg = (OUT / "base_420_q75.jpg").read_bytes()
    png_bytes = (OUT / "pil_rgb8.png").read_bytes()
    (OUT / "bad_garbage.jpg").write_bytes(b"\xff\xd8\xff" + bytes(
        rng.integers(0, 256, 400).astype(np.uint8)))
    (OUT / "bad_truncated.jpg").write_bytes(jpeg[:len(jpeg) // 2])
    Image.fromarray(img).convert("CMYK").save(OUT / "bad_cmyk.jpg",
                                              quality=90)
    (OUT / "bad_truncated.png").write_bytes(png_bytes[:len(png_bytes) // 2])
    bad_crc = bytearray(png_bytes)
    bad_crc[40] ^= 1
    (OUT / "bad_crc.png").write_bytes(bytes(bad_crc))
    (OUT / "bad_garbage.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"x" * 64)
    names += ["bad_garbage.jpg", "bad_truncated.jpg", "bad_cmyk.jpg",
              "bad_truncated.png", "bad_crc.png", "bad_garbage.png"]
    return names


def main() -> None:
    sys.path.insert(0, str(REPO))
    from denoise_gan_tpu.data import native as jnative

    if not jnative.available():
        raise SystemExit("the JAX package's libjpeg/libpng codec is needed")
    names = write_fixtures()
    files = {}
    for name in names:
        img = jnative.decode(str(OUT / name))
        files[name] = {"sha256": digest(img),
                       "shape": None if img is None else list(img.shape)}
    roundtrip = {}
    for h, w in RT_SIZES:
        img = seeded_image(h, w, RT_SEED)
        for q in RT_QUALITIES:
            roundtrip[roundtrip_key(h, w, q)] = digest(
                jnative.jpeg_roundtrip_u8(img, q))
    SIDECAR.write_text(json.dumps(
        {"files": files, "roundtrip_seed": RT_SEED, "roundtrip": roundtrip},
        indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(names)} fixtures and {len(roundtrip)} round-trip hashes in "
          f"{OUT} ({total} bytes)")


if __name__ == "__main__":
    main()
