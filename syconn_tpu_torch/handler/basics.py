"""Small host-side utilities: list chunking, pickle/kzip IO, the chunked
volume factory, ``temp_seed`` and ``safe_copy`` (counterpart of
``syconn_tpu/handler/basics.py``).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import tempfile
import zipfile
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "chunkify",
    "chunkify_weighted",
    "chunkify_successive",
    "flatten_list",
    "load_pkl2obj",
    "write_obj2pkl",
    "kd_factory",
    "data2kzip",
    "read_txt_from_zip",
    "read_data_from_zip",
    "write_txt2kzip",
    "remove_from_zip",
    "temp_seed",
    "safe_copy",
]


def chunkify(lst: Sequence, n: int) -> List[List]:
    """Split ``lst`` into ``n`` interleaved sublists (round-robin)."""
    n = max(1, min(n, len(lst))) if len(lst) else 1
    return [list(lst[i::n]) for i in range(n)]


def chunkify_weighted(lst: Sequence, n: int, weights: np.ndarray) -> List[List]:
    """Split into ``n`` sublists, greedy by descending weight (round-robin on
    the weight-sorted order) so that the heaviest items spread across chunks."""
    lst = np.asarray(lst, dtype=object) if not isinstance(lst, np.ndarray) else lst
    order = np.argsort(weights)[::-1]
    sorted_lst = [lst[i] for i in order]
    n = max(1, min(n, len(sorted_lst))) if len(sorted_lst) else 1
    return [sorted_lst[i::n] for i in range(n)]


def chunkify_successive(lst: Sequence, size: int) -> List[List]:
    """Split into consecutive chunks of at most ``size`` elements."""
    return [list(lst[i : i + size]) for i in range(0, len(lst), size)]


def flatten_list(lst) -> list:
    return [el for sub in lst for el in sub]


def load_pkl2obj(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def write_obj2pkl(path: str, obj: Any):
    """Atomic pickle write (tmp file + rename)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(obj, f, protocol=4)
        os.replace(tmp, path)
    except BaseException:
        if os.path.isfile(tmp):
            os.remove(tmp)
        raise


# --------------------------------------------------------------------- kd IO
_kd_cache: Dict[str, Any] = {}


def kd_factory(kd_path: str, channel: Optional[str] = None):
    """Cached factory for chunked voxel volumes: the port's
    :class:`..io.chunked.ChunkedVolume` opened at ``kd_path``."""
    key = os.path.abspath(kd_path)
    if key not in _kd_cache:
        from ..io.chunked import ChunkedVolume

        _kd_cache[key] = ChunkedVolume.open(kd_path)
    return _kd_cache[key]


def clear_kd_cache():
    _kd_cache.clear()


# --------------------------------------------------------------------- kzip
def data2kzip(
    kzip_path: str,
    fpaths: Sequence[str],
    fnames_in_zip: Optional[Sequence[str]] = None,
    force_overwrite: bool = False,
    verbose: bool = False,
):
    """Add files to a (KNOSSOS-style) zip archive."""
    if fnames_in_zip is None:
        fnames_in_zip = [os.path.basename(p) for p in fpaths]
    mode = "w" if (force_overwrite or not os.path.isfile(kzip_path)) else "a"
    os.makedirs(os.path.dirname(os.path.abspath(kzip_path)), exist_ok=True)
    with zipfile.ZipFile(kzip_path, mode, zipfile.ZIP_DEFLATED) as zf:
        for src, name in zip(fpaths, fnames_in_zip):
            zf.write(src, name)


def write_txt2kzip(kzip_path: str, text, fname_in_zip: str, force_overwrite: bool = False):
    if isinstance(text, str):
        text = text.encode()
    mode = "w" if (force_overwrite or not os.path.isfile(kzip_path)) else "a"
    os.makedirs(os.path.dirname(os.path.abspath(kzip_path)) or ".", exist_ok=True)
    with zipfile.ZipFile(kzip_path, mode, zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(fname_in_zip, text)


def read_txt_from_zip(zip_path: str, fname: str) -> bytes:
    with zipfile.ZipFile(zip_path, "r") as zf:
        return zf.read(fname)


def read_data_from_zip(zip_path: str, fname: str) -> bytes:
    return read_txt_from_zip(zip_path, fname)


def remove_from_zip(zip_path: str, *fnames: str):
    """Rewrite the archive without ``fnames`` (through a temporary file
    beside it)."""
    tmp_fd, tmp_path = tempfile.mkstemp(
        suffix=".zip", dir=os.path.dirname(os.path.abspath(zip_path)))
    os.close(tmp_fd)
    try:
        with zipfile.ZipFile(zip_path, "r") as zin, zipfile.ZipFile(
            tmp_path, "w", zipfile.ZIP_DEFLATED
        ) as zout:
            for item in zin.infolist():
                if item.filename not in fnames:
                    zout.writestr(item, zin.read(item.filename))
        shutil.move(tmp_path, zip_path)
    finally:
        if os.path.isfile(tmp_path):
            os.remove(tmp_path)


@contextlib.contextmanager
def temp_seed(seed: int):
    """Temporarily seed numpy's global RNG."""
    state = np.random.get_state()
    np.random.seed(seed)
    try:
        yield
    finally:
        np.random.set_state(state)


def safe_copy(src: str, dst: str, safe: bool = True):
    """Copy ``src`` to ``dst``; with ``safe``, refuse to overwrite."""
    if safe and os.path.isfile(dst):
        raise FileExistsError(dst)
    shutil.copy(src, dst)
