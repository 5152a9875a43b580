"""Array (de)compression and HDF5 helpers (counterpart of
``syconn_tpu/handler/compression.py``).

The codec is the stores' (``backend/base.py``): zstd where the
``zstandard`` package imports, the standard library's zlib otherwise, told
apart per payload by its first bytes, so each reads the other. With
zstandard the bytes equal the JAX package's. ``h5py`` is imported by
the two HDF5 helpers only; where it is not installed they raise
``ImportError``.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from ..backend.base import _compress, _decompress

__all__ = [
    "compress_arr",
    "decompress_arr",
    "arrtolz4string_list",
    "lz4string_listtoarr",
    "load_from_h5py",
    "save_to_h5py",
]


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("the HDF5 helpers need the h5py package, which is not installed") from e
    return h5py


def compress_arr(arr: np.ndarray, level: int = 3) -> bytes:
    """Compress an ndarray (C-contiguous bytes; dtype/shape kept by caller)."""
    return _compress(np.ascontiguousarray(arr).tobytes(), level)


def decompress_arr(buf: bytes, dtype, shape) -> np.ndarray:
    return np.frombuffer(_decompress(buf), dtype=dtype).reshape(shape).copy()


def arrtolz4string_list(arr: np.ndarray) -> List[bytes]:
    """Compress an array into a list of byte strings (the reference's name;
    the codec is zstd or zlib, see the module docstring)."""
    if arr is None or arr.size == 0:
        return [b""]
    return [_compress(np.ascontiguousarray(arr).tobytes())]


def lz4string_listtoarr(
    str_lst: Union[List[bytes], bytes], dtype=np.float32, shape=None
) -> np.ndarray:
    """Inverse of :func:`arrtolz4string_list`."""
    if isinstance(str_lst, bytes):
        str_lst = [str_lst]
    if len(str_lst) == 0 or (len(str_lst) == 1 and str_lst[0] == b""):
        out = np.zeros((0,), dtype=dtype)
        return out if shape is None else out.reshape(shape)
    parts = [np.frombuffer(_decompress(s), dtype=dtype) for s in str_lst]
    arr = np.concatenate(parts) if len(parts) > 1 else parts[0]
    if shape is not None:
        arr = arr.reshape(shape)
    return arr.copy()


def load_from_h5py(
    path: str, hdf5_names: Optional[Sequence[str]] = None, as_dict: bool = False
) -> Union[List[np.ndarray], Dict[str, np.ndarray]]:
    """Load datasets from an HDF5 file (all of them without ``hdf5_names``)."""
    with _h5py().File(path, "r") as f:
        if hdf5_names is None:
            hdf5_names = list(f.keys())
        if as_dict:
            return {name: f[name][()] for name in hdf5_names}
        return [f[name][()] for name in hdf5_names]


def save_to_h5py(
    data: Union[Dict[str, np.ndarray], Iterable[np.ndarray]],
    path: str,
    hdf5_names: Optional[Sequence[str]] = None,
    overwrite: bool = True,
    compression: bool = True,
):
    """Save arrays to an HDF5 file, one dataset each (gzip level 1 with
    ``compression``)."""
    h5py = _h5py()
    if os.path.isfile(path) and overwrite:
        os.remove(path)
    if not isinstance(data, dict):
        data_list = list(data)
        if hdf5_names is None or len(hdf5_names) != len(data_list):
            raise ValueError("hdf5_names must match the number of arrays.")
        data = dict(zip(hdf5_names, data_list))
    kwargs = {"compression": "gzip", "compression_opts": 1} if compression else {}
    with h5py.File(path, "w") as f:
        for name, arr in data.items():
            f.create_dataset(name, data=arr, **kwargs)
