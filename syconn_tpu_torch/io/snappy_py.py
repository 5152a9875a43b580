"""Pure-Python snappy codec, block format (counterpart of
``syconn_tpu/io/snappy_py.py``).

KNOSSOS segmentation cubes ship as snappy blocks inside zip containers
(``.seg.sz.zip``), and neither this repository's machines nor the card
machine have ``python-snappy``, so the public block format
(github.com/google/snappy/blob/main/format_description.txt) is implemented
here:

* :func:`compress` writes literals only (a legal stream every decoder
  reads; zip's deflate wraps the cubes anyway), byte for byte as the JAX
  package does;
* :func:`decompress` is the full decoder (literals and the three copy
  kinds), so cubes written by KNOSSOS or knossos_utils load too.
"""

from __future__ import annotations

__all__ = ["compress", "decompress"]

_MAX_LITERAL = (1 << 32) - 1


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int):
    shift = 0
    result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 35:
            raise ValueError("varint too long for snappy length")


def compress(data: bytes) -> bytes:
    """Encode ``data`` as a literal-only snappy block stream."""
    data = bytes(data)
    out = bytearray(_varint(len(data)))
    pos = 0
    n = len(data)
    while pos < n:
        chunk = min(n - pos, _MAX_LITERAL)
        length = chunk - 1
        if length < 60:
            out.append(length << 2)
        elif length < (1 << 8):
            out.append(60 << 2)
            out += length.to_bytes(1, "little")
        elif length < (1 << 16):
            out.append(61 << 2)
            out += length.to_bytes(2, "little")
        elif length < (1 << 24):
            out.append(62 << 2)
            out += length.to_bytes(3, "little")
        else:
            out.append(63 << 2)
            out += length.to_bytes(4, "little")
        out += data[pos: pos + chunk]
        pos += chunk
    return bytes(out)


def decompress(data: bytes) -> bytes:
    """Decode a snappy block stream (literals and all three copy kinds)."""
    data = bytes(data)
    expected, pos = _read_varint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 0x03
        if kind == 0:  # literal
            length = tag >> 2
            if length >= 60:
                nbytes = length - 59
                length = int.from_bytes(data[pos: pos + nbytes], "little")
                pos += nbytes
            length += 1
            out += data[pos: pos + length]
            pos += length
            continue
        if kind == 1:  # copy, 1-byte offset
            length = ((tag >> 2) & 0x07) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos: pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos: pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("invalid snappy copy offset")
        start = len(out) - offset
        if offset >= length:
            out += out[start: start + length]
        else:
            # an overlapping copy repeats the last ``offset`` bytes: double
            # the run until it is long enough, then cut it
            run = bytes(out[start:])
            while len(run) < length:
                run = run + run
            out += run[:length]
    if len(out) != expected:
        raise ValueError(f"snappy length mismatch: header {expected}, decoded {len(out)}")
    return bytes(out)
