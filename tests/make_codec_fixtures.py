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
Arithmetic-coded JPEGs by tests/make_arith_jpeg.cpp, compiled here
against libjpeg.  The cut and corrupt files libjpeg and libpng read in
part (cut_*, marker_*, badcode_*, rst_*, prog_*, arith_*, png_*) are
those files edited here.  Needs cv2, PIL, g++ with libjpeg's headers and
the JAX binding's libjpeg/libpng build; run once:

    python tests/make_codec_fixtures.py
"""

from __future__ import annotations

import json
import struct
import subprocess
import sys
import tempfile
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
# sklearn's china.jpg (the port's copy) cut at these fractions of its
# bytes: every cut falls inside its scan, where libjpeg reads it in part
PHOTO = REPO / "denoise_gan_tpu_torch" / "assets" / "photos" / "china.jpg"
PHOTO_CUTS = (0.5, 0.9, 0.99)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def photo_cut(data: bytes, frac: float) -> bytes:
    """The first `frac` of a file's bytes."""
    return data[:int(len(data) * frac)]


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
def write_fixtures() -> tuple[list[str], list[str]]:
    """Every fixture's name, and those of the cut and corrupt files that
    libjpeg and libpng read in part or refuse."""
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
    partial = corrupt_jpegs(cv2) + arith_jpegs() + partial_pngs()
    return names + partial, partial


# ------------------------------------------------------ cut and corrupt
def scan_spans(data: bytes) -> list[tuple[int, int, int]]:
    """(SOS marker, first data byte, end of data) of each scan: the data
    runs to the first marker that is not FF 00 or an RSTn, or to the end
    of a file cut inside it."""
    spans, i = [], 2
    while i + 3 < len(data):
        if data[i] != 0xFF or data[i + 1] in (0x00, 0xFF):
            i += 1
            continue
        marker = data[i + 1]
        length = data[i + 2] << 8 | data[i + 3]
        if marker != 0xDA:
            i += 2 + length
            continue
        j = start = i + 2 + length
        while j + 1 < len(data) and not (
                data[j] == 0xFF and data[j + 1] != 0
                and not 0xD0 <= data[j + 1] <= 0xD7):
            j += 1
        j = min(j, len(data))
        spans.append((i, start, j))
        i = j
    return spans


def cut_in_scan(data: bytes, scan: int, frac: float) -> bytes:
    """The file cut `frac` of the way through scan `scan`'s data."""
    _, a, b = scan_spans(data)[scan]
    return data[:a + int((b - a) * frac)]


def insert_in_scan(data: bytes, scan: int, frac: float, extra: bytes
                   ) -> bytes:
    _, a, b = scan_spans(data)[scan]
    at = a + int((b - a) * frac)
    return data[:at] + extra + data[at:]


def scan_groups(data: bytes) -> tuple[bytes, list[bytes]]:
    """The headers before the first scan's tables, and each scan with the
    table segments just before it (a progressive file from libjpeg)."""
    spans = scan_spans(data)
    starts = []
    for k, (sos, _, _) in enumerate(spans):
        begin = spans[k - 1][2] if k else sos
        if k == 0:      # the tables after SOF that belong to scan 0
            j = 2
            while True:
                length = data[j + 2] << 8 | data[j + 3]
                if data[j + 1] in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
                    begin = j + 2 + length
                    break
                j += 2 + length
        starts.append(begin)
    groups = [data[s:spans[k][2]] for k, s in enumerate(starts)]
    return data[:starts[0]], groups


def corrupt_jpegs(cv2) -> list[str]:
    """JPEGs cut or damaged inside their scans, each a case libjpeg reads
    with a warning: data ending early, a marker in the data, bad Huffman
    codes, restart markers out of sequence, scans out of order, and
    progressive files whose AC bands stay incomplete (block smoothing)."""
    files = {}
    base = (OUT / "base_420_q95.jpg").read_bytes()
    base75 = (OUT / "base_420_q75.jpg").read_bytes()
    prog = (OUT / "prog_q30.jpg").read_bytes()
    rst = (OUT / "rst1_q75.jpg").read_bytes()
    small = seeded_image(37, 53, 7)
    ok, enc = cv2.imencode(".jpg", small[..., ::-1], [
        cv2.IMWRITE_JPEG_QUALITY, 60, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
        cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    rst_prog = enc.tobytes()
    sof1 = bytearray((OUT / "base_444_q75.jpg").read_bytes())
    sof1[bytes(sof1).index(b"\xff\xc0") + 1] = 0xC1    # extended Huffman
    n_scans = len(scan_spans(prog))
    # (a) the data ends inside a scan
    files["cut_base_420.jpg"] = cut_in_scan(base, 0, 0.7)
    files["cut_ext_444.jpg"] = cut_in_scan(bytes(sof1), 0, 0.6)
    files["cut_prog_dc.jpg"] = cut_in_scan(prog, 0, 0.5)
    files["cut_prog_ac.jpg"] = cut_in_scan(prog, 4, 0.5)
    files["cut_prog_last.jpg"] = cut_in_scan(prog, n_scans - 1, 0.4)
    files["cut_prog_gray.jpg"] = cut_in_scan(
        (OUT / "gray_prog_q50.jpg").read_bytes(), 2, 0.5)
    files["cut_rst_prog.jpg"] = cut_in_scan(rst_prog, 1, 0.55)
    # (a) a marker inside the data
    files["marker_in_scan.jpg"] = insert_in_scan(base75, 0, 0.5,
                                                 b"\xff\xd3")
    files["marker_in_prog_scan.jpg"] = insert_in_scan(prog, 2, 0.5,
                                                      b"\xff\xd5")
    # (b) progressive files that stop after a scan: the DC scan alone, and
    # half the scans (AC 1-9 incomplete: libjpeg smooths the blocks)
    head, groups = scan_groups(prog)
    files["prog_dc_only.jpg"] = head + groups[0] + b"\xff\xd9"
    files["prog_half_scans.jpg"] = head + b"".join(groups[:5]) + b"\xff\xd9"
    # (c) 32 one bits: no Huffman code is all ones
    ones = b"\xff\x00" * 4
    files["badcode_base.jpg"] = insert_in_scan(base75, 0, 0.3, ones)
    files["badcode_prog.jpg"] = insert_in_scan(prog, 1, 0.3, ones)
    # (d) restart markers renumbered (one ahead, one behind, one far off)
    # and one dropped
    marks = [i for i in range(len(rst) - 1)
             if rst[i] == 0xFF and 0xD0 <= rst[i + 1] <= 0xD7]
    renum = bytearray(rst)
    for k, shift in ((2, 1), (5, -2), (8, 4)):
        renum[marks[k] + 1] = 0xD0 + (renum[marks[k] + 1] - 0xD0 + shift) % 8
    files["rst_renumbered.jpg"] = bytes(renum)
    files["rst_dropped.jpg"] = rst[:marks[4]] + rst[marks[4] + 2:]
    # (e) progressive scans out of order
    swapped = list(groups)
    swapped[1], swapped[4] = swapped[4], swapped[1]
    files["prog_reordered.jpg"] = head + b"".join(swapped) + b"\xff\xd9"
    files["prog_ac_first.jpg"] = (head + groups[1] + groups[0]
                                  + b"".join(groups[2:]) + b"\xff\xd9")
    files["prog_refined_twice.jpg"] = (head + b"".join(groups[:6])
                                       + groups[5] + b"".join(groups[6:])
                                       + b"\xff\xd9")
    for name, data in files.items():
        (OUT / name).write_bytes(data)
    return list(files)


def arith_jpegs() -> list[str]:
    """(g) Arithmetic-coded JPEGs (SOF9, SOF10 with DAC) by tests/
    make_arith_jpeg.cpp: sequential and progressive, colour and gray,
    libjpeg's default conditioning and others, restart intervals, and a
    progressive one cut inside a scan."""
    src = Path(__file__).with_name("make_arith_jpeg.cpp")
    cases = {  # name: (h, w, channels, quality, progressive, restart,
               #        dc_L, dc_U, ac_K)
        "arith_seq_420.jpg": (37, 53, 3, 75, 0, 0, 0, 1, 5),
        "arith_prog_420_dac.jpg": (37, 53, 3, 50, 1, 0, 2, 6, 10),
        "arith_seq_gray_rst.jpg": (29, 41, 1, 90, 0, 2, 3, 9, 30),
        "arith_prog_rst.jpg": (40, 48, 3, 30, 1, 3, 0, 1, 5),
    }
    names = []
    with tempfile.TemporaryDirectory() as tmp:
        exe = Path(tmp) / "make_arith_jpeg"
        subprocess.run(["g++", "-O2", str(src), "-ljpeg", "-o", str(exe)],
                       check=True)
        for i, (name, (h, w, ch, *args)) in enumerate(cases.items()):
            img = seeded_image(h, w, 70 + i)
            if ch == 1:
                img = img[..., 1]
            subprocess.run([str(exe), str(OUT / name), str(w), str(h),
                            str(ch), *map(str, args)],
                           input=np.ascontiguousarray(img).tobytes(),
                           check=True)
            names.append(name)
    prog = (OUT / "arith_prog_rst.jpg").read_bytes()
    (OUT / "cut_arith_prog.jpg").write_bytes(cut_in_scan(prog, 3, 0.5))
    return names + ["cut_arith_prog.jpg"]


def partial_pngs() -> list[str]:
    """(f) PNGs libpng reads in part or whole where Python's zlib alone
    would not: a bad Adler-32 read after the last row (in a later IDAT, or
    in a later 8192-byte piece of one IDAT) and one read with the rows
    (None); a stream not ended when the rows are, with its last bytes in
    a later IDAT; more data than the image; no IEND; bad CRCs on the
    chunks after the last IDAT libpng reads."""
    rng = np.random.default_rng(8)
    rgb = rng.integers(0, 256, (13, 19, 3)).astype(np.uint8)
    rows = np.zeros((13, 1 + 3 * 19), np.uint8)
    rows[:, 1:] = rgb.reshape(13, -1)
    raw = rows.tobytes()
    head = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 19, 13, 8, 2, 0, 0, 0))
    iend = _chunk(b"IEND", b"")
    z = zlib.compress(raw)
    bad = z[:-4] + bytes([z[-4] ^ 1]) + z[-3:]
    co = zlib.compressobj()
    flushed = co.compress(raw) + co.flush(zlib.Z_SYNC_FLUSH)
    # a gray image whose stored stream puts its Adler-32 just past the
    # first 8192 bytes of its one IDAT
    gray = rng.integers(0, 256, (5, 1636)).astype(np.uint8)
    grows = np.zeros((5, 1637), np.uint8)
    grows[:, 1:] = gray
    stored = zlib.compress(grows.tobytes(), 0)
    assert len(stored) == 8192 + 4
    stored = stored[:-4] + bytes([stored[-4] ^ 1]) + stored[-3:]
    ghead = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 1636, 5, 8, 0, 0, 0, 0))
    files = {
        "png_adler_later_idat.png": head + _chunk(b"IDAT", bad[:-4])
        + _chunk(b"IDAT", bad[-4:]) + iend,
        "bad_adler_same_idat.png": head + _chunk(b"IDAT", bad) + iend,
        "png_adler_later_piece.png": ghead + _chunk(b"IDAT", stored) + iend,
        "png_unended.png": head + _chunk(b"IDAT", flushed)
        + _chunk(b"IDAT", b"\x03\x00") + iend,
        "bad_png_unended.png": head + _chunk(b"IDAT", flushed) + iend,
        "png_extra_data.png": head + _chunk(b"IDAT", zlib.compress(
            raw + raw[:40])) + iend,
        "png_no_iend.png": head + _chunk(b"IDAT", z),
        "png_bad_crc_after.png": head + _chunk(b"IDAT", z)
        + _chunk(b"IDAT", b"xy")[:-1] + b"\x00" + iend[:-1] + b"\x00",
    }
    for name, data in files.items():
        (OUT / name).write_bytes(data)
    return list(files)


def main() -> None:
    sys.path.insert(0, str(REPO))
    from denoise_gan_tpu.data import native as jnative

    if not jnative.available():
        raise SystemExit("the JAX package's libjpeg/libpng codec is needed")
    names, partial = write_fixtures()
    files = {}
    for name in names:
        img = jnative.decode(str(OUT / name))
        files[name] = {"sha256": digest(img),
                       "shape": None if img is None else list(img.shape)}
    photo = PHOTO.read_bytes()
    cuts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for frac in PHOTO_CUTS:
            path = Path(tmp) / "cut.jpg"
            path.write_bytes(photo_cut(photo, frac))
            cuts[str(frac)] = digest(jnative.decode(str(path)))
    roundtrip = {}
    for h, w in RT_SIZES:
        img = seeded_image(h, w, RT_SEED)
        for q in RT_QUALITIES:
            roundtrip[roundtrip_key(h, w, q)] = digest(
                jnative.jpeg_roundtrip_u8(img, q))
    SIDECAR.write_text(json.dumps(
        {"files": files, "partial": sorted(partial), "photo_cuts": cuts,
         "roundtrip_seed": RT_SEED, "roundtrip": roundtrip},
        indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(names)} fixtures and {len(roundtrip)} round-trip hashes in "
          f"{OUT} ({total} bytes)")


if __name__ == "__main__":
    main()
