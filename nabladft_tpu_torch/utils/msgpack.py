"""A reader for the msgpack that ``flax.serialization`` writes.

Pure Python (the package depends on no msgpack library): maps, arrays, str,
bin, ints, floats, nil and bool, plus flax's extension types

  * 1 — an ndarray, itself msgpack of ``(shape, dtype name, C-order bytes)``;
  * 2 — a native complex, msgpack of ``(real, imag)``;
  * 3 — a numpy scalar, encoded as a 0-d ndarray;

and flax's chunked arrays (a map with ``__msgpack_chunked_array__``, its
``shape`` and its flat ``chunks``, each keyed "0", "1", ...), which flax
writes for arrays above 2**30 bytes. `unpackb` returns the nested dicts
(and lists) with numpy leaves; a bfloat16 leaf, which numpy has no type
for, is read as its uint16 bits and returned as a ``torch.bfloat16`` tensor.
There is no writer.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

_FIXED = {  # code -> (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, buf: bytes, raw: bool = False):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw  # str as bytes (flax reads the ndarray triple so)

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _uint(self, size: int) -> int:
        return struct.unpack(_LEN[size], self._take(size))[0]

    def _str(self, n: int):
        b = bytes(self._take(n))
        return b if self.raw else b.decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int) -> Any:
        code = struct.unpack(">b", self._take(1))[0]
        return _ext(code, bytes(self._take(n)))

    def read(self) -> Any:
        c = self._take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self._array(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return self._str(c & 0x1F)
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        if c in _FIXED:
            fmt, size = _FIXED[c]
            return struct.unpack(fmt, self._take(size))[0]
        if c in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self._take(self._uint(1 << (c - 0xC4))))
        if c in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            return self._ext(self._uint(1 << (c - 0xC7)))
        if 0xD4 <= c <= 0xD8:  # fixext 1/2/4/8/16
            return self._ext(1 << (c - 0xD4))
        if c in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self._str(self._uint(1 << (c - 0xD9)))
        if c in (0xDC, 0xDD):  # array 16/32
            return self._array(self._uint(2 if c == 0xDC else 4))
        if c in (0xDE, 0xDF):  # map 16/32
            return self._map(self._uint(2 if c == 0xDE else 4))
        raise ValueError(f"msgpack type byte 0x{c:02x} is not valid")


def _ndarray(data: bytes):
    """flax's ndarray encoding: numpy, or torch.bfloat16 from its bits."""
    shape, dtype, buf = _Reader(data, raw=True).read()
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    shape = tuple(shape)
    if dtype == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy()


def _ext(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        arr = _ndarray(data)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    if code == EXT_COMPLEX:
        re, im = _Reader(data).read()
        return complex(re, im)
    raise ValueError(f"msgpack extension type {code} is not one flax writes")


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data: bytes) -> Any:
    """The tree `flax.serialization.msgpack_serialize` (or `to_bytes`) wrote."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack object")
    return _unchunk(out)


def load(path: Path) -> Any:
    return unpackb(Path(path).read_bytes())


def opens_a_map(path: Path) -> bool:
    """Whether the file starts as every flax state does: with a msgpack map."""
    with open(path, "rb") as f:
        head = f.read(1)
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))
