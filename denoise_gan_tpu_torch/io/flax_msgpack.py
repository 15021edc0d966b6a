"""The msgpack subset that ``flax.serialization`` writes, in plain Python.

A ``.dgt`` export's payload is ``flax.serialization.to_bytes`` of
``{"params": ..., "batch_stats": ...}`` (denoise_gan_tpu/io/checkpoint.py:
69-84): nested maps with str keys whose leaves are msgpack ext values.
Ext type 1 holds an ndarray as ``packb((shape, dtype_name, bytes))``, type
3 a numpy scalar in the same form.  The machine with the card has no
``msgpack`` and no ``flax``, so the port reads and writes this form
itself.

Decoded: maps, arrays, str, bin, ints, floats, nil, bool and ext types 1
and 3.  An array of dtype ``bfloat16`` (which numpy lacks) becomes a
``torch.bfloat16`` tensor, read through a 16-bit integer view; every
other dtype a read-only numpy array over the payload.  Flax splits a leaf
of 2**30 bytes or more into ``{"__msgpack_chunked_array__": True, ...}``;
no generator has one (the largest, pix2pix's 4x4x1024x512 kernel, is ~34
MB), and decoding one raises ValueError.

Encoded: str-keyed maps of numpy arrays and torch tensors (bf16 tensors
under the dtype name ``bfloat16``), with msgpack's shortest headers, as
``msgpack.packb`` writes them.
"""

from __future__ import annotations

import struct
from collections.abc import Mapping

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """Sequential msgpack decoder over one bytes object."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack payload")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack("B")
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        fixed = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in fixed:
            return fixed[b]
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.unpack(">" + "BHI"[b - 0xc4])))
        if b in (0xc7, 0xc8, 0xc9):
            n = self.unpack(">" + "BHI"[b - 0xc7])
            return self.ext(n)
        if b in (0xca, 0xcb):
            return self.unpack(">" + "fd"[b - 0xca])
        if 0xcc <= b <= 0xd3:
            return self.unpack(">" + "BHIQbhiq"[b - 0xcc])
        if 0xd4 <= b <= 0xd8:
            return self.ext(1 << (b - 0xd4))
        if b in (0xd9, 0xda, 0xdb):
            return self.str(self.unpack(">" + "BHI"[b - 0xd9]))
        if b in (0xdc, 0xdd):
            return self.array(self.unpack(">" + "HI"[b - 0xdc]))
        if b in (0xde, 0xdf):
            return self.map(self.unpack(">" + "HI"[b - 0xde]))
        raise ValueError(f"msgpack type byte {b:#04x} is not supported")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if CHUNKED in out:
            raise ValueError("a chunked array leaf (flax writes one for a "
                             "leaf of 2**30 bytes or more) is not supported")
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        body = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not supported")
        inner = _Reader(body)
        shape, dtype, buf = inner.value()
        arr = _array(tuple(shape), dtype, buf)
        return arr if code == EXT_NDARRAY else arr[()]


def _array(shape: tuple[int, ...], dtype, buf: bytes):
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":
        bits = np.frombuffer(buf, np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(dtype)).reshape(shape)


def loads(data: bytes):
    """Decode one msgpack value (see the module docstring)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         "msgpack value")
    return out


def _head(n: int, fix: int | None, fix_max: int, codes: tuple[int, ...]
          ) -> bytes:
    """msgpack's shortest header for a length `n`: the fix form (`fix` |
    n) up to fix_max, then the 8/16/32-bit forms in `codes` (one fewer
    when the type has no 8-bit form)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    widths = ((0xff, ">B"), (0xffff, ">H"), (0xffffffff, ">I"))
    for code, (top, fmt) in zip(codes, widths[3 - len(codes):]):
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit msgpack")


def _str(s: str) -> bytes:
    b = s.encode()
    return _head(len(b), 0xa0, 31, (0xd9, 0xda, 0xdb)) + b


def _uint(n: int) -> bytes:
    if n <= 0x7f:
        return bytes([n])
    for code, top, fmt in ((0xcc, 0xff, ">B"), (0xcd, 0xffff, ">H"),
                           (0xce, 0xffffffff, ">I")):
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    return b"\xcf" + struct.pack(">Q", n)


def _ndarray(leaf) -> bytes:
    """Ext type 1 of an array, 3 of a numpy scalar: packb((shape,
    dtype_name, C-order bytes))."""
    code = EXT_NPSCALAR if isinstance(leaf, np.generic) else EXT_NDARRAY
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        t = leaf.detach().cpu().contiguous()
        shape, name = tuple(t.shape), "bfloat16"
        buf = t.view(torch.int16).numpy().tobytes()
    else:
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) \
            else np.asarray(leaf)
        shape, name, buf = arr.shape, arr.dtype.name, arr.tobytes("C")
    body = (b"\x93" + _head(len(shape), 0x90, 15, (0xdc, 0xdd))
            + b"".join(_uint(int(d)) for d in shape) + _str(name)
            + _head(len(buf), None, 0, (0xc4, 0xc5, 0xc6)) + buf)
    n = len(body)
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    head = bytes([fixext[n]]) if n in fixext else \
        _head(n, None, 0, (0xc7, 0xc8, 0xc9))
    return head + bytes([code]) + body


def dumps(tree: Mapping) -> bytes:
    """Encode a str-keyed tree of maps whose leaves are numpy arrays or
    torch tensors, as flax's ``to_bytes`` encodes such a tree."""
    parts = [_head(len(tree), 0x80, 15, (0xde, 0xdf))]
    for key, value in tree.items():
        parts.append(_str(str(key)))
        parts.append(dumps(value) if isinstance(value, Mapping)
                     else _ndarray(value))
    return b"".join(parts)
