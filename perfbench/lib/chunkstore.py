"""Read a chunked volume back from disk, written from the store's on-disk
format alone: ``meta.json`` (``boundary``, ``chunk_shape``, ``codec``) and
one compressed blob of uint8 per chunk at
``<path>/<channel>/mag<m>/c_<x>_<y>_<z>.zst``."""

from __future__ import annotations

import json
import os
import zlib

import numpy as np


class MissingOutput(RuntimeError):
    pass


def _decompress(codec: str, buf: bytes) -> bytes:
    if codec == "zlib":
        return zlib.decompress(buf)
    import zstandard

    return zstandard.ZstdDecompressor().decompress(buf)


def read_raw(path: str, mag: int = 1) -> np.ndarray:
    """The whole ``raw`` channel at ``mag`` as (x, y, z) uint8; raises
    :class:`MissingOutput` when the store or one of its chunks is missing."""
    meta_p = os.path.join(path, "meta.json")
    if not os.path.isfile(meta_p):
        raise MissingOutput(f"no store at {path}")
    with open(meta_p) as f:
        meta = json.load(f)
    codec = meta.get("codec", "zstd")
    cs = [int(c) for c in meta["chunk_shape"]]
    shape = [-(-int(b) // mag) for b in meta["boundary"]]
    out = np.empty(shape, np.uint8)
    grid = [-(-s // c) for s, c in zip(shape, cs)]
    for cx in range(grid[0]):
        for cy in range(grid[1]):
            for cz in range(grid[2]):
                p = os.path.join(path, "raw", f"mag{mag}", f"c_{cx}_{cy}_{cz}.zst")
                if not os.path.isfile(p):
                    raise MissingOutput(f"missing chunk {p}")
                with open(p, "rb") as f:
                    chunk = np.frombuffer(_decompress(codec, f.read()), np.uint8)
                if chunk.size != cs[0] * cs[1] * cs[2]:
                    raise MissingOutput(f"chunk {p} holds {chunk.size} bytes")
                chunk = chunk.reshape(cs)
                o = (cx * cs[0], cy * cs[1], cz * cs[2])
                e = [min(c, s - a) for c, s, a in zip(cs, shape, o)]
                out[o[0]:o[0] + e[0], o[1]:o[1] + e[1], o[2]:o[2] + e[2]] = \
                    chunk[:e[0], :e[1], :e[2]]
    return out


def bytes_on_disk(path: str) -> int:
    tot = 0
    for d, _, files in os.walk(path):
        for f in files:
            tot += os.path.getsize(os.path.join(d, f))
    return tot
