"""Pure-Python reader for the msgpack files that flax writes.

Counterpart of ``flax.serialization.msgpack_restore`` as used by
``syconn_tpu/models/io.py:109-112``, for machines without the ``msgpack``
package. It decodes the subset flax emits — maps, arrays, str, bin, ints,
floats, nil/bool and ext — where ext code 1 is an ndarray whose payload is
itself msgpack of ``(shape, dtype name, raw bytes)``, code 2 a complex and
code 3 a numpy scalar. Oversized arrays that flax split into
``__msgpack_chunked_array__`` maps are joined again.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

__all__ = ["msgpack_restore", "unpackb"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, buf: bytes, raw: bool, ext_hook=None):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        p = self.pos
        if p + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        self.pos = p + n
        return self.buf[p:p + n]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if self.ext_hook is None:
            return (code, data)
        return self.ext_hook(code, data)

    def obj(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        if t == 0xC0:
            return None
        if t == 0xC2:
            return False
        if t == 0xC3:
            return True
        if t in (0xC4, 0xC5, 0xC6):
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[t])
            return bytes(self.take(n))
        if t in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t]))
        if t == 0xCA:
            return self.unpack(">f")
        if t == 0xCB:
            return self.unpack(">d")
        if 0xCC <= t <= 0xD3:
            return self.unpack(
                {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}[t])
        if 0xD4 <= t <= 0xD8:
            return self.ext(1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):
            return self.str_(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[t]))
        if t in (0xDC, 0xDD):
            n = self.unpack(">H" if t == 0xDC else ">I")
            return [self.obj() for _ in range(n)]
        if t in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(buf: bytes, raw: bool = False, ext_hook=None) -> Any:
    """Decode one msgpack object (arrays become lists, as msgpack's
    ``use_list=True``)."""
    r = _Reader(buf, raw, ext_hook)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _dtype(name: bytes):
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        raise TypeError("bfloat16 leaves are not supported by the reader")
    return np.dtype(name)


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype, buf = unpackb(data, raw=True)
    return np.frombuffer(buf, dtype=_dtype(dtype)).reshape(shape, order="C").copy()


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    return (code, data)


def _tuple_of(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(d):
    if isinstance(d, dict):
        if "__msgpack_chunked_array__" in d:
            flat = np.concatenate(_tuple_of(d["chunks"]))
            return flat.reshape(_tuple_of(d["shape"]))
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v)
    return d


def msgpack_restore(encoded: bytes):
    """Restore the tree flax's ``msgpack_serialize``/``to_bytes`` wrote:
    nested dicts with numpy array leaves."""
    return _unchunk(unpackb(encoded, raw=False, ext_hook=_ext_hook))
