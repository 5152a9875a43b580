"""Chunked voxel volume store (counterpart of ``syconn_tpu/io/chunked.py``).

Same on-disk layout as the JAX package: ``meta.json`` plus one compressed
blob per chunk at ``<channel>/mag<m>/c_<x>_<y>_<z>.zst``, arrays indexed
``[x, y, z]``, offsets and sizes in the target mag's frame, a power-of-two
mag pyramid, ``raw`` (uint8) and ``seg`` (uint64, stored narrowed) channels.

The codec is recorded in the metadata (``"codec"``: ``"zstd"`` or
``"zlib"``; a store without the key is zstd). A new store writes zstd when
the ``zstandard`` package imports and the standard library's ``zlib``
otherwise; both are read.

Writes go through to disk before ``save_raw``/``save_seg`` return, except
inside :meth:`ChunkedVolume.assembling`, which assembles chunks that writes
cover in part in host memory and writes each once it is covered.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import tracing

try:
    import zstandard as _zstd
except ImportError:  # not installed on every machine
    _zstd = None

__all__ = ["ChunkedVolume", "clear_chunk_cache", "default_codec"]

_tls = threading.local()
_CHANNEL_DTYPES = {"raw": np.uint8, "seg": np.uint64}


def default_codec() -> str:
    return "zstd" if _zstd is not None else "zlib"


def _compress(codec: str, data: bytes) -> bytes:
    if codec == "zlib":
        return zlib.compress(data, 1)
    c = getattr(_tls, "cctx", None)
    if c is None:  # zstd contexts are not thread-safe
        c = _tls.cctx = _zstd.ZstdCompressor(level=1)
    return c.compress(data)


def _decompress(codec: str, buf: bytes) -> bytes:
    if codec == "zlib":
        return zlib.decompress(buf)
    if _zstd is None:
        raise RuntimeError("this store is zstd-compressed and zstandard is not installed")
    d = getattr(_tls, "dctx", None)
    if d is None:
        d = _tls.dctx = _zstd.ZstdDecompressor()
    return d.decompress(buf)


# ------------------------------------------------------ decompressed cache
# A chunk+halo read touches up to 8 neighbouring chunks; a process-wide LRU
# of decompressed chunks (keyed by file path, invalidated on write) makes
# each chunk pay its decompression once. Budget: SYCONN_TPU_CHUNK_CACHE_GB,
# shared with the chunks staged by ``ChunkedVolume.assembling`` (below),
# which the cache gives way to.
_cc_lock = threading.Lock()
_cc_store: "dict[str, np.ndarray]" = {}
_cc_bytes = 0
# staged chunks by file path, oldest first; each entry is changed, written
# and removed under its volume's lock of that chunk
_staged: "dict[str, _Staged]" = {}
_st_bytes = 0


class _Staged:
    """A chunk being assembled: its buffer, the voxels its pieces covered
    inside the volume (overlaps counted twice), the voxels it needs and the
    pieces copied in."""

    __slots__ = ("vol", "channel", "mag", "cix", "buf", "count", "need", "pieces")

    def __init__(self, vol, channel, mag, cix, buf, need):
        self.vol, self.channel, self.mag, self.cix = vol, channel, mag, cix
        self.buf, self.need, self.count, self.pieces = buf, need, 0, 0


def _cc_budget() -> int:
    try:
        gb = float(os.environ.get("SYCONN_TPU_CHUNK_CACHE_GB", "8"))
    except ValueError:
        gb = 8.0
    return int(gb * (1 << 30))


def _chunk_cache_get(path: str) -> Optional[np.ndarray]:
    """The chunk's staged buffer, else its cached decompressed array."""
    with _cc_lock:
        ent = _staged.get(path)
        if ent is not None:
            return ent.buf
        arr = _cc_store.pop(path, None)
        if arr is not None:
            _cc_store[path] = arr  # move to end = most recent
        return arr


def _chunk_cache_put(path: str, arr: np.ndarray) -> None:
    global _cc_bytes
    budget = _cc_budget()
    if budget <= 0 or arr.nbytes > budget:
        return
    with _cc_lock:
        old = _cc_store.pop(path, None)
        if old is not None:
            _cc_bytes -= old.nbytes
        while _cc_bytes + _st_bytes + arr.nbytes > budget and _cc_store:
            _cc_bytes -= _cc_store.pop(next(iter(_cc_store))).nbytes
        if _st_bytes + arr.nbytes <= budget:
            _cc_store[path] = arr
            _cc_bytes += arr.nbytes


def _chunk_cache_invalidate(path: str) -> None:
    global _cc_bytes
    with _cc_lock:
        old = _cc_store.pop(path, None)
        if old is not None:
            _cc_bytes -= old.nbytes


def clear_chunk_cache() -> None:
    """Empty the decompressed cache (staged chunks are kept: they are
    written when their ``assembling`` context ends)."""
    global _cc_bytes
    with _cc_lock:
        _cc_store.clear()
        _cc_bytes = 0


def _stage_put(path: str, ent: _Staged) -> None:
    """Register a staged chunk; the cache gives way to it."""
    global _cc_bytes, _st_bytes
    budget = _cc_budget()
    with _cc_lock:
        _staged[path] = ent
        _st_bytes += ent.buf.nbytes
        while _cc_bytes + _st_bytes > budget and _cc_store:
            _cc_bytes -= _cc_store.pop(next(iter(_cc_store))).nbytes


def _stage_pop(path: str) -> Optional[_Staged]:
    global _st_bytes
    with _cc_lock:
        ent = _staged.pop(path, None)
        if ent is not None:
            _st_bytes -= ent.buf.nbytes
        return ent


def _stage_trim() -> None:
    """Write the oldest staged chunks as they stand while the staged bytes
    pass the budget. The caller holds no chunk lock."""
    budget = _cc_budget()
    while True:
        with _cc_lock:
            if _st_bytes <= budget or not _staged:
                return
            path, ent = next(iter(_staged.items()))
        ent.vol._write_staged(path)


def _cdiv(a, b):
    return -(-a // b)


class ChunkedVolume:
    """A directory-backed chunked 3D volume with raw and seg channels."""

    def __init__(self, path: str, meta: dict):
        self.path = path
        self._meta = meta
        self._codec = meta.get("codec", "zstd")
        self._io_threads = int(meta.get("io_threads", 16))
        self._pool: Optional[ThreadPoolExecutor] = None
        # per-chunk locks: concurrent writers read-modify-write shared
        # border chunks (e.g. mag-pyramid writes from adjacent tiles)
        self._locks_guard = threading.Lock()
        self._chunk_locks: Dict[str, threading.Lock] = {}
        # writer threads register channels and mags of one store at once
        self._meta_lock = threading.Lock()
        self._assembling = 0  # open assembling() contexts

    def _chunk_lock(self, path: str) -> threading.Lock:
        with self._locks_guard:
            lk = self._chunk_locks.get(path)
            if lk is None:
                lk = self._chunk_locks[path] = threading.Lock()
            return lk

    # ------------------------------------------------------------- lifecycle
    @classmethod
    def create(cls, path: str, scale: Sequence[float], boundary: Sequence[int],
               experiment_name: str = "", chunk_shape: Sequence[int] = (256, 256, 256),
               mags: Sequence[int] = (1,), offset: Sequence[int] = (0, 0, 0),
               codec: Optional[str] = None) -> "ChunkedVolume":
        codec = codec or default_codec()
        if codec not in ("zstd", "zlib"):
            raise ValueError(f"unknown codec {codec!r}")
        if codec == "zstd" and _zstd is None:
            raise RuntimeError("codec 'zstd' needs the zstandard package")
        meta = {
            "format_version": 1,
            "experiment_name": experiment_name,
            "scale": [float(s) for s in scale],
            "boundary": [int(b) for b in boundary],
            "offset": [int(o) for o in offset],
            "chunk_shape": [int(c) for c in chunk_shape],
            "mags": sorted(int(m) for m in mags),
            "channels": {},
            "codec": codec,
        }
        os.makedirs(path, exist_ok=True)
        cv = cls(path, meta)
        cv._save_meta()
        return cv

    @classmethod
    def open(cls, path: str) -> "ChunkedVolume":
        meta_p = os.path.join(path, "meta.json")
        if not os.path.isfile(meta_p):
            raise FileNotFoundError(f"No chunked volume at {path}.")
        with open(meta_p) as f:
            return cls(path, json.load(f))

    @classmethod
    def exists(cls, path: str) -> bool:
        return os.path.isfile(os.path.join(path, "meta.json"))

    def _save_meta(self):
        """Dump ``_meta``; callers on shared volumes hold ``_meta_lock``."""
        tmp = os.path.join(self.path, f"meta.json.tmp{os.getpid()}_{threading.get_ident()}")
        with open(tmp, "w") as f:
            json.dump(self._meta, f, indent=1)
        os.replace(tmp, os.path.join(self.path, "meta.json"))

    # ------------------------------------------------------------ properties
    @property
    def codec(self) -> str:
        return self._codec

    @property
    def scale(self) -> np.ndarray:
        return np.array(self._meta["scale"], dtype=np.float32)

    @property
    def boundary(self) -> np.ndarray:
        """Volume shape (x, y, z) at mag 1."""
        return np.array(self._meta["boundary"], dtype=np.int64)

    @property
    def shape(self) -> np.ndarray:
        return self.boundary

    @property
    def chunk_shape(self) -> np.ndarray:
        return np.array(self._meta["chunk_shape"], dtype=np.int64)

    @property
    def available_mags(self) -> List[int]:
        return list(self._meta["mags"])

    @property
    def experiment_name(self) -> str:
        return self._meta.get("experiment_name", "")

    def mag_shape(self, mag: int) -> np.ndarray:
        return _cdiv(self.boundary, mag)

    def _get_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self._io_threads)
        return self._pool

    def __getstate__(self):
        d = self.__dict__.copy()
        d["_pool"] = None
        return d

    # ------------------------------------------------------------- chunk IO
    def _chunk_path(self, channel: str, mag: int, cix: Tuple[int, int, int]) -> str:
        return os.path.join(self.path, channel, f"mag{mag}",
                            f"c_{cix[0]}_{cix[1]}_{cix[2]}.zst")

    def _read_chunk(self, channel: str, mag: int, cix, dtype) -> Optional[np.ndarray]:
        p = self._chunk_path(channel, mag, cix)
        cached = _chunk_cache_get(p)
        if cached is not None:
            return cached
        if not os.path.isfile(p):
            return None
        with open(p, "rb") as f:
            raw = _decompress(self._codec, f.read())
        cs = tuple(self.chunk_shape)
        itemsize = len(raw) // int(np.prod(cs))
        if itemsize == np.dtype(dtype).itemsize:
            out = np.frombuffer(raw, dtype=dtype).reshape(cs)
        else:
            # seg chunks are stored in the narrowest unsigned dtype holding
            # their max label; the width follows from the byte count
            narrow = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[itemsize]
            out = np.frombuffer(raw, dtype=narrow).reshape(cs).astype(dtype)
        _chunk_cache_put(p, out)
        return out

    def _write_chunk(self, channel: str, mag: int, cix, data: np.ndarray):
        p = self._chunk_path(channel, mag, cix)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        data = np.ascontiguousarray(data)
        if channel == "seg" and data.dtype.itemsize > 1:
            mx = int(data.max(initial=0))
            for narrow in (np.uint8, np.uint16, np.uint32):
                if mx <= np.iinfo(narrow).max:
                    data = np.ascontiguousarray(data.astype(narrow))
                    break
        tmp = p + f".tmp{os.getpid()}_{threading.get_ident()}"
        with tracing.span("chunk.compress"):
            buf = _compress(self._codec, data.tobytes())
        with open(tmp, "wb") as f:
            f.write(buf)
        os.replace(tmp, p)
        _chunk_cache_invalidate(p)

    # ------------------------------------------------------------ region IO
    def _chunk_jobs(self, offset, size):
        cs = self.chunk_shape
        c0 = offset // cs
        c1 = _cdiv(offset + size, cs)
        return [(cx, cy, cz) for cx in range(c0[0], c1[0])
                for cy in range(c0[1], c1[1]) for cz in range(c0[2], c1[2])]

    def _run(self, work, jobs):
        if len(jobs) > 1:
            list(self._get_pool().map(tracing.carry(work), jobs))
        else:
            for j in jobs:
                work(j)

    def _load(self, channel: str, offset, size, mag: int) -> np.ndarray:
        dtype = _CHANNEL_DTYPES[channel]
        offset = np.asarray(offset, dtype=np.int64)
        size = np.asarray(size, dtype=np.int64)
        cs = self.chunk_shape
        out = np.zeros(tuple(size), dtype=dtype)

        def work(cix):
            chunk = self._read_chunk(channel, mag, cix, dtype)
            if chunk is None:
                return
            cofs = np.array(cix) * cs
            lo = np.maximum(cofs, offset)
            hi = np.minimum(cofs + cs, offset + size)
            if np.any(hi <= lo):
                return
            out[lo[0] - offset[0]:hi[0] - offset[0], lo[1] - offset[1]:hi[1] - offset[1],
                lo[2] - offset[2]:hi[2] - offset[2]] = chunk[
                lo[0] - cofs[0]:hi[0] - cofs[0], lo[1] - cofs[1]:hi[1] - cofs[1],
                lo[2] - cofs[2]:hi[2] - cofs[2]]

        self._run(work, self._chunk_jobs(offset, size))
        return out

    def _save(self, channel: str, data: np.ndarray, offset, mag: int):
        dtype = _CHANNEL_DTYPES[channel]
        data = np.asarray(data)
        if data.dtype != dtype:
            data = data.astype(dtype)
        offset = np.asarray(offset, dtype=np.int64)
        size = np.array(data.shape, dtype=np.int64)
        cs = self.chunk_shape
        chunk_bytes = int(np.prod(cs)) * np.dtype(dtype).itemsize

        def work(cix):
            cofs = np.array(cix) * cs
            lo = np.maximum(cofs, offset)
            hi = np.minimum(cofs + cs, offset + size)
            if np.any(hi <= lo):
                return
            src = data[lo[0] - offset[0]:hi[0] - offset[0], lo[1] - offset[1]:hi[1] - offset[1],
                       lo[2] - offset[2]:hi[2] - offset[2]]
            inner = tuple(slice(a - c, b - c) for a, b, c in zip(lo, hi, cofs))
            path = self._chunk_path(channel, mag, cix)
            lock = self._chunk_lock(path)
            created = False
            with tracing.span("chunk.lock_wait"):
                lock.acquire()
            try:
                if np.all(lo == cofs) and np.all(hi == cofs + cs):
                    if self._assembling:
                        _stage_pop(path)
                    with tracing.span("chunk.write", key=path, rmw=False, pieces=1, early=False):
                        self._write_chunk(channel, mag, cix, src)
                elif self._assembling and chunk_bytes <= _cc_budget():
                    created = self._stage(channel, mag, cix, path, inner, src, lo, hi)
                else:
                    with tracing.span("chunk.rmw_read"):
                        chunk = self._read_chunk(channel, mag, cix, dtype)
                        chunk = (np.zeros(tuple(cs), dtype=dtype) if chunk is None
                                 else chunk.copy())
                    chunk[inner] = src
                    with tracing.span("chunk.write", key=path, rmw=True, pieces=1, early=False):
                        self._write_chunk(channel, mag, cix, chunk)
            finally:
                lock.release()
            if created:
                _stage_trim()

        self._run(work, self._chunk_jobs(offset, size))
        with self._meta_lock:
            chans = self._meta.setdefault("channels", {})
            if channel not in chans:
                chans[channel] = {"dtype": np.dtype(dtype).name}
                self._save_meta()

    def _stage(self, channel, mag, cix, path, inner, src, lo, hi) -> bool:
        """Copy a piece into the chunk's staged buffer, created from what the
        chunk holds (staged, cached, on disk, else zeros), and write the
        buffer once the pieces have covered the chunk's part inside the
        volume. Holds the chunk's lock. True where it created the buffer."""
        dtype = _CHANNEL_DTYPES[channel]
        cofs = np.array(cix) * self.chunk_shape
        end = np.minimum(cofs + self.chunk_shape, self.mag_shape(mag))
        with _cc_lock:
            ent = _staged.get(path)
        created = ent is None
        if created:
            with tracing.span("chunk.rmw_read"):
                chunk = self._read_chunk(channel, mag, cix, dtype)
                buf = (np.zeros(tuple(self.chunk_shape), dtype=dtype) if chunk is None
                       else chunk.copy())
            ent = _Staged(self, channel, mag, cix, buf, int(np.prod(np.maximum(end - cofs, 0))))
            _stage_put(path, ent)
        with tracing.span("chunk.stage"):
            ent.buf[inner] = src
        ent.pieces += 1
        ent.count += int(np.prod(np.maximum(np.minimum(hi, end) - lo, 0)))
        if ent.count >= ent.need:
            _stage_pop(path)
            with tracing.span("chunk.write", key=path, rmw=True, pieces=ent.pieces, early=False):
                self._write_chunk(channel, mag, cix, ent.buf)
        return created

    def _write_staged(self, path: str) -> None:
        """Write a staged chunk as it stands (the budget or the context's end
        forced it), unless a writer wrote it meanwhile."""
        with self._chunk_lock(path):
            ent = _stage_pop(path)
            if ent is not None:
                with tracing.span("chunk.write", key=path, rmw=True, pieces=ent.pieces,
                                  early=True):
                    self._write_chunk(ent.channel, ent.mag, ent.cix, ent.buf)

    @contextlib.contextmanager
    def assembling(self):
        """Write each chunk once while a caller writes a volume piece by piece.

        Inside the context a write that covers a chunk only in part copies
        its piece into a staged buffer of the chunk (made once from what the
        chunk holds: cache, file, else zeros), and the chunk is compressed
        and written when its pieces have covered its part inside the volume
        (``mag_shape``), under the chunk's lock as every write. Pieces that
        overlap count twice and write the chunk early; a later piece then
        stages it again from the file: the result is the same, only slower.
        A write that covers a whole chunk goes to disk at once and drops the
        chunk's staged buffer. Reads of this path's chunks (``load_raw``,
        ``load_seg``) see staged pieces; a read racing a write of the same
        chunk sees each voxel before or after it.

        Staged bytes count against the decompressed cache's budget
        (``SYCONN_TPU_CHUNK_CACHE_GB``): past it the oldest staged chunk is
        written as it stands, and a chunk larger than the budget is written
        through. When the outermost context ends, on success or on an
        exception, every chunk still staged is written, so the store on disk
        is what write-through would have left. End it after the writes it
        encloses have returned. Re-entrant, and shared by the threads that
        write to this volume object.
        """
        with self._locks_guard:
            self._assembling += 1
        try:
            yield self
        finally:
            with self._locks_guard:
                self._assembling -= 1
                last = self._assembling == 0
            if last:
                with _cc_lock:
                    paths = [p for p, e in _staged.items() if e.vol is self]
                errors = []
                for p in paths:
                    try:
                        self._write_staged(p)
                    except Exception as e:  # noqa: BLE001 - write the others, then raise
                        errors.append(e)
                if errors:
                    raise errors[0]

    # ----------------------------------------------------------- public API
    def load_raw(self, offset=(0, 0, 0), size=None, mag: int = 1) -> np.ndarray:
        if size is None:
            size = self.mag_shape(mag) - np.asarray(offset)
        with tracing.span("chunk.load", mag=mag):
            return self._load("raw", offset, size, mag)

    def load_seg(self, offset=(0, 0, 0), size=None, mag: int = 1) -> np.ndarray:
        if size is None:
            size = self.mag_shape(mag) - np.asarray(offset)
        return self._load("seg", offset, size, mag)

    def save_raw(self, data: np.ndarray, offset=(0, 0, 0), mags: Sequence[int] = (1,),
                 data_mag: int = 1, downsample: str = "mean"):
        with tracing.span("chunk.save", mags=tuple(mags)):
            self._save_multi_mag("raw", data, offset, mags, data_mag, downsample=downsample)

    def save_seg(self, data: np.ndarray, offset=(0, 0, 0), mags: Sequence[int] = (1,),
                 data_mag: int = 1):
        self._save_multi_mag("seg", data, offset, mags, data_mag, downsample="stride")

    def _save_multi_mag(self, channel, data, offset, mags, data_mag, downsample):
        offset = np.asarray(offset, dtype=np.int64)
        for mag in sorted(mags):
            if mag < data_mag:
                raise ValueError(f"Cannot upsample from mag {data_mag} to {mag}.")
            f = mag // data_mag
            if f > 1 and np.any(offset % f):
                # a floored offset would de-phase the pyramid between writes
                raise ValueError(
                    f"offset {tuple(offset)} not aligned to downsample factor "
                    f"{f} (mag {mag} from data_mag {data_mag})")
            if f == 1:
                d = data
            else:
                with tracing.span("chunk.downsample", mag=mag, mode=downsample,
                                  voxels=int(np.prod(_cdiv(np.array(data.shape), f)))):
                    if downsample == "stride":
                        d = data[::f, ::f, ::f]
                    else:  # mean pooling, edge-padded to a multiple of f
                        sh = np.array(data.shape)
                        dp = np.pad(data.astype(np.float32), [(0, p) for p in (-sh) % f],
                                    mode="edge")
                        d = dp.reshape(dp.shape[0] // f, f, dp.shape[1] // f, f,
                                       dp.shape[2] // f, f).mean(axis=(1, 3, 5)).astype(data.dtype)
            self._save(channel, d, offset // f, mag)
            with self._meta_lock:
                if mag not in self._meta["mags"]:
                    self._meta["mags"] = sorted(set(self._meta["mags"]) | {mag})
                    self._save_meta()

    # --------------------------------------------------- reference-style init
    @classmethod
    def initialize_from_matrix(
        cls,
        path: str,
        scale,
        experiment_name: str,
        data: Optional[np.ndarray] = None,
        data_path: Optional[str] = None,
        hdf5_names: Optional[Sequence[str]] = None,
        offset=(0, 0, 0),
        boundary=None,
        mags: Sequence[int] = (1,),
        chunk_shape=(256, 256, 256),
        fast_downsampling: bool = True,
        channel: str = "raw",
    ) -> "ChunkedVolume":
        """Create a volume from an in-memory array, or from the first of
        ``hdf5_names`` in the HDF5 file ``data_path`` (through
        ``handler.compression.load_from_h5py``, which needs h5py), and write
        it at every mag of ``mags`` (``fast_downsampling`` is accepted and
        unused, as in the JAX package)."""
        if data is None:
            from ..handler.compression import load_from_h5py

            data = load_from_h5py(data_path, hdf5_names=list(hdf5_names))[0]
        data = np.asarray(data)
        if boundary is None:
            boundary = np.array(data.shape, dtype=np.int64)
        cv = cls.create(
            path,
            scale=scale,
            boundary=boundary,
            experiment_name=experiment_name,
            chunk_shape=chunk_shape,
            mags=mags,
        )
        if channel == "raw":
            cv.save_raw(data, offset=offset, mags=mags, data_mag=1)
        else:
            cv.save_seg(data, offset=offset, mags=mags, data_mag=1)
        return cv
