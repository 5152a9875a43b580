"""Dict-like persistent shard stores (counterpart of
``syconn_tpu/backend/base.py``, same pickle layout): a shard file maps
object IDs to values; values are held compressed in memory and
decompressed on first access. Writes are atomic (tmp file + rename);
locking is an optional fcntl flock (the pipeline itself is single-writer).

An array payload is ``(compressed bytes, dtype string, shape)``. The JAX
package always compresses with zstd. The port writes zstd when the
``zstandard`` package imports and the standard library's zlib otherwise,
and tells the two apart per payload by their first bytes: a zstd frame
begins ``28 B5 2F FD``, a zlib stream ``0x78``. So no store needs a record
of its codec, and each package reads the other's zstd stores; a store the
port wrote with zlib is unreadable to the JAX package.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Iterator, Optional

import threading
import zlib

import numpy as np

from ..utils.locking import InterProcessLock, LockTimeout

try:
    import zstandard as _zstd
except ImportError:  # not installed on every machine
    _zstd = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
# zstd (de)compressor objects are not thread-safe -> thread-local instances
_tls = threading.local()


def _compress(data: bytes, level: int = 3) -> bytes:
    if _zstd is None:
        return zlib.compress(data, min(level, 9))
    if level != 3:
        return _zstd.ZstdCompressor(level=level).compress(data)
    c = getattr(_tls, "cctx", None)
    if c is None:
        c = _tls.cctx = _zstd.ZstdCompressor(level=3)
    return c.compress(data)


def _decompress(buf: bytes) -> bytes:
    if buf[:4] == _ZSTD_MAGIC:
        if _zstd is None:
            raise RuntimeError("this payload is zstd-compressed and zstandard is not installed")
        d = getattr(_tls, "dctx", None)
        if d is None:
            d = _tls.dctx = _zstd.ZstdDecompressor()
        return d.decompress(buf)
    if buf[:1] == b"\x78":
        return zlib.decompress(buf)
    raise ValueError(f"payload is neither zstd nor zlib (first bytes {bytes(buf[:4]).hex()})")


class StorageBase:
    """Base class: pickled dict of ``id -> compressed payload`` on disk."""

    # subclasses set this to encode/decode values
    def _encode(self, value: Any) -> Any:
        return value

    def _decode(self, payload: Any) -> Any:
        return payload

    def __init__(
        self,
        inp_p: str,
        read_only: bool = True,
        disable_locking: bool = False,
        timeout: float = 30.0,
        cache_decomp: bool = True,
    ):
        self._path = inp_p
        self.read_only = read_only
        self._disable_locking = disable_locking
        self._timeout = timeout
        self._cache_decomp = cache_decomp
        self._dc_intern: dict = {}
        self._cache_dc: dict = {}
        self._lock: Optional[InterProcessLock] = None
        if inp_p is not None:
            self.pull()

    # ------------------------------------------------------------------ util
    @property
    def path(self) -> str:
        return self._path

    def _lock_path(self) -> str:
        d, b = os.path.split(self._path)
        return os.path.join(d, f".{b}.lk")

    def _acquire_lock(self):
        if self._disable_locking or self.read_only or self._lock is not None:
            return
        self._lock = InterProcessLock(self._lock_path())
        if not self._lock.acquire(timeout=self._timeout):
            self._lock = None
            raise LockTimeout(
                f"Could not acquire write lock for {self._path} within {self._timeout}s."
            )

    def _release_lock(self):
        if self._lock is not None:
            self._lock.release()
            self._lock = None

    # ------------------------------------------------------------------- IO
    def pull(self):
        """(Re-)read the shard file."""
        self._acquire_lock()
        if os.path.isfile(self._path):
            with open(self._path, "rb") as f:
                self._dc_intern = pickle.load(f)
        else:
            self._dc_intern = {}

    def push(self):
        """Write the shard file atomically and release the write lock."""
        if self.read_only:
            self._release_lock()
            return
        d = os.path.dirname(self._path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self._path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(self._dc_intern, f, protocol=4)
        os.replace(tmp, self._path)
        self._release_lock()

    def save2pkl(self, path: Optional[str] = None):
        if path is not None:
            self._path = path
            self.read_only = False
        self.push()

    # ------------------------------------------------------------- dict API
    def __getitem__(self, key):
        if key in self._cache_dc:
            return self._cache_dc[key]
        value = self._decode(self._dc_intern[key])
        if self._cache_decomp:
            self._cache_dc[key] = value
        return value

    def __setitem__(self, key, value):
        if self.read_only:
            raise RuntimeError(f"Store {self._path} is read-only.")
        self._cache_dc[key] = value
        self._dc_intern[key] = self._encode(value)

    def __delitem__(self, key):
        self._dc_intern.pop(key, None)
        self._cache_dc.pop(key, None)

    def __contains__(self, key) -> bool:
        return key in self._dc_intern

    def __len__(self) -> int:
        return len(self._dc_intern)

    def __iter__(self) -> Iterator:
        return iter(self._dc_intern)

    def keys(self):
        return self._dc_intern.keys()

    def items(self):
        for k in self._dc_intern:
            yield k, self[k]

    def values(self):
        for k in self._dc_intern:
            yield self[k]

    def get(self, key, default=None):
        return self[key] if key in self else default

    def update(self, other: dict):
        for k, v in other.items():
            self[k] = v

    def clear_cache(self):
        self._cache_dc.clear()

    def __del__(self):
        try:
            self._release_lock()
        except Exception:
            pass


class BTBase:
    """Placeholder for a big-table backend, as in the reference: only the
    file-system stores exist."""

    def __init__(self, *a, **kw):
        raise NotImplementedError("Big-table backend not implemented; use FS stores.")


FSBase = StorageBase  # reference alias


def compress_payload(arr: np.ndarray) -> tuple:
    """Compress an ndarray, keeping dtype/shape for exact round-trip."""
    arr = np.ascontiguousarray(arr)
    return (_compress(arr.tobytes()), str(arr.dtype), arr.shape)


def decompress_payload(payload: tuple) -> np.ndarray:
    buf, dtype, shape = payload
    return np.frombuffer(_decompress(buf), dtype=np.dtype(dtype)).reshape(shape).copy()
