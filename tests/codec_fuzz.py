"""Fuzz the port's image codec (denoise_gan_tpu_torch/data/native.py)
against the JAX package's libjpeg/libpng binding (denoise_gan_tpu/data/
native.py) on mutated files, byte for byte: JPEGs cut inside their scans,
with markers inserted in them, with bytes replaced (in the scans and
anywhere after SOI), with progressive scans shuffled, dropped or
repeated, with restart markers renumbered or removed; arithmetic-coded
JPEGs (tests/make_arith_jpeg.cpp) cut and flipped; PNGs cut, with IDAT
bytes replaced (CRC kept right or not), and with the end of their zlib
stream flipped.  Sources: the codec fixtures, the port's photographs and
textures, and JPEGs cv2 writes at every sampling, progressive and with
restart intervals.  Prints the cases and each mismatch; exits 1 on one.
Needs cv2, g++ with libjpeg and the JAX binding; not a test (no test
runs it).

    python tests/codec_fuzz.py [--per 40] [--seed 0]
"""

from __future__ import annotations

import argparse
import ctypes
import random
import struct
import subprocess
import sys
import tempfile
import zlib
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import make_codec_fixtures as mcf  # noqa: E402
from denoise_gan_tpu.data import native as jnative  # noqa: E402
from denoise_gan_tpu_torch.data import native as pnative  # noqa: E402
from denoise_gan_tpu_torch.data import png as ppng  # noqa: E402

ASSETS = REPO / "denoise_gan_tpu_torch" / "assets"


def _decoder(lib, owned: bool):
    """bytes -> RGB uint8 or None through a library's dg_decode (the
    port's returns a buffer it allocates, the binding's writes into ours)."""
    def decode(data: bytes):
        h, w = ctypes.c_int(), ctypes.c_int()
        if owned:
            buf = ctypes.c_void_p()
            if lib.dg_decode(data, len(data), ctypes.byref(buf),
                             ctypes.byref(h), ctypes.byref(w)) != 0:
                return None
            out = np.empty((h.value, w.value, 3), np.uint8)
            ctypes.memmove(out.ctypes.data, buf, out.nbytes)
            lib.dg_free(buf)
            return out
        if lib.dg_decode(data, len(data), None, ctypes.byref(h),
                         ctypes.byref(w)) != 0:
            return None
        out = np.empty((h.value, w.value, 3), np.uint8)
        if lib.dg_decode(data, len(data), out.ctypes.data, ctypes.byref(h),
                         ctypes.byref(w)) != 0:
            return None
        return out
    return decode


def jpeg_sources(cv2, arith_exe: Path, tmp: Path) -> dict[str, bytes]:
    out = {p.name: p.read_bytes()
           for p in sorted(mcf.OUT.glob("*.jpg")) if "bad_" not in p.name}
    out.update({p.name: p.read_bytes()
                for p in sorted((ASSETS / "photos").glob("*.jpg"))})
    img = cv2.imread(str(ASSETS / "photos" / "flower.jpg"))[:200, :300]
    for samp in ("444", "422", "420", "440", "411"):
        f = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{samp}")
        for q in (20, 80):
            for name, extra in (
                    ("prog", [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
                    ("rst", [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
                    ("rstprog", [cv2.IMWRITE_JPEG_RST_INTERVAL, 3,
                                 cv2.IMWRITE_JPEG_PROGRESSIVE, 1])):
                ok, enc = cv2.imencode(".jpg", img, [
                    cv2.IMWRITE_JPEG_QUALITY, q,
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, f, *extra])
                out[f"cv2_{name}_{samp}_{q}.jpg"] = enc.tobytes()
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    ok, enc = cv2.imencode(".jpg", gray, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    out["cv2_prog_gray.jpg"] = enc.tobytes()
    rgb = np.ascontiguousarray(img[..., ::-1])
    for i, (h, w, c, q, prog, rst, lo, hi, k) in enumerate((
            (37, 53, 3, 75, 0, 0, 0, 1, 5), (120, 200, 3, 30, 1, 0, 2, 6, 10),
            (120, 200, 3, 90, 0, 0, 1, 3, 2), (64, 80, 3, 50, 1, 4, 3, 9, 30),
            (50, 61, 1, 60, 1, 0, 0, 1, 5), (50, 61, 1, 95, 0, 2, 5, 12, 63),
            (9, 9, 3, 75, 1, 0, 0, 1, 5))):
        src = rgb[:h, :w] if c == 3 else gray[:h, :w]
        path = tmp / f"arith{i}.jpg"
        subprocess.run([str(arith_exe), str(path), str(w), str(h), str(c),
                        str(q), str(prog), str(rst), str(lo), str(hi),
                        str(k)], input=np.ascontiguousarray(src).tobytes(),
                       check=True)
        out[f"arith{i}.jpg"] = path.read_bytes()
    return out


def jpeg_cases(name: str, d: bytes, rng: random.Random, per: int):
    spans = mcf.scan_spans(d)
    a0 = spans[0][1]
    for _ in range(per):
        yield "cut", d[:rng.randrange(a0, len(d))]
        at = rng.randrange(a0, len(d) - 2)
        yield "marker", d[:at] + bytes([0xFF, rng.choice(
            [0xD0, 0xD3, 0xD7, 0xD9, 0xC4, 0x01, 0xFE, 0xE1, 0xDA])]) + d[at:]
        b = bytearray(d)
        for _ in range(rng.randrange(1, 4)):
            b[rng.randrange(a0, len(d) - 2)] = rng.randrange(256)
        yield "flip", bytes(b)
        b = bytearray(d)
        b[rng.randrange(2, len(d))] = rng.randrange(256)
        yield "flip anywhere", bytes(b)
    if len(spans) > 1 and not name.startswith("arith"):
        head, groups = mcf.scan_groups(d)
        for _ in range(per):
            g = list(groups)
            op = rng.randrange(3)
            if op == 0:
                rng.shuffle(g)
            elif op == 1:
                del g[rng.randrange(len(g))]
            else:
                g.insert(rng.randrange(len(g)), g[rng.randrange(len(g))])
            yield "scans", head + b"".join(g) + b"\xff\xd9"
    marks = [i for i in range(len(d) - 1)
             if d[i] == 0xFF and 0xD0 <= d[i + 1] <= 0xD7]
    for _ in range(per if marks else 0):
        b = bytearray(d)
        for _ in range(rng.randrange(1, 4)):
            i = rng.choice(marks)
            op = rng.randrange(3)
            if op == 0:
                b[i + 1] = 0xD0 + rng.randrange(8)
            elif op == 1:
                b[i + 1] = rng.choice([0xC4, 0x02, 0xE3, 0xD9, 0xDB])
            else:
                b[i] = 0x00
        yield "restarts", bytes(b)


def png_cases(d: bytes, rng: random.Random, per: int):
    spans, i = [], 8
    while i + 8 <= len(d):
        n, kind = struct.unpack(">I4s", d[i:i + 8])
        if kind == b"IDAT":
            spans.append((i + 8, i + 8 + n))
        i += 12 + n
    for _ in range(per):
        yield "cut", d[:rng.randrange(8, len(d))]
        for where in ("flip", "stream end"):
            b = bytearray(d)
            s, e = rng.choice(spans) if where == "flip" else spans[-1]
            at = rng.randrange(s if where == "flip" else max(s, e - 8), e)
            b[at] = rng.randrange(256) if where == "flip" else \
                b[at] ^ (1 << rng.randrange(8))
            if where != "flip" or rng.random() < 0.7:
                b[e:e + 4] = struct.pack(">I", zlib.crc32(bytes(b[s - 4:e])))
            yield where, bytes(b)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--per", type=int, default=40,
                   help="cases of each kind a source")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    import cv2
    jdecode = _decoder(jnative._load(), owned=False)
    plib = pnative._load()
    pdecode = _decoder(plib, owned=True)
    unfilter = pnative._unfilter(plib)
    rng = random.Random(args.seed)
    counts, bad = {}, []

    def check(kind: str, name: str, data: bytes, is_png: bool):
        want = jdecode(data)
        got = ppng.decode(data, unfilter) if is_png else pdecode(data)
        counts[kind] = counts.get(kind, 0) + 1
        if (want is None) != (got is None) or (
                want is not None and not np.array_equal(want, got)):
            bad.append((kind, name, len(data)))

    with tempfile.TemporaryDirectory() as tmp:
        exe = Path(tmp) / "make_arith_jpeg"
        subprocess.run(["g++", "-O2", str(REPO / "tests" /
                                          "make_arith_jpeg.cpp"), "-ljpeg",
                        "-o", str(exe)], check=True)
        for name, d in jpeg_sources(cv2, exe, Path(tmp)).items():
            check("jpeg whole", name, d, False)
            for kind, data in jpeg_cases(name, d, rng, args.per):
                check(f"jpeg {kind}", name, data, False)
    pngs = [p for p in sorted(mcf.OUT.glob("*.png")) if "bad_" not in p.name]
    for path in pngs + sorted((ASSETS / "textures").glob("*.png")):
        per = args.per if path.parent == mcf.OUT else max(1, args.per // 8)
        for kind, data in png_cases(path.read_bytes(), rng, per):
            check(f"png {kind}", path.name, data, True)
    for kind, n in sorted(counts.items()):
        print(f"{kind}: {n}")
    print(f"{sum(counts.values())} cases, {len(bad)} differ from the "
          "binding")
    for case in bad[:20]:
        print("  ", case)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
