"""BinarySearchStore: O(log n) attribute lookup over sorted ids (counterpart
of ``syconn_tpu/backend/bst.py``, without h5py).

The ids are sorted once at build time and split into contiguous shards;
queries binary-search the shards' first ids, then the shard. The JAX package
keeps the shards in one HDF5 file; the port keeps the same arrays in one
uncompressed numpy ``.npz`` archive (``n_shards``, ``n_elements``,
``shard_starts``, ``bounds``, and ``shard_<i>/ids``, ``shard_<i>/<attr>``),
read lazily per array. The container is not HDF5, so datasets name it
differently (``sv2ssv.npz`` beside the JAX package's ``sv2ssv.h5``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

__all__ = ["BinarySearchStore"]


class BinarySearchStore:
    def __init__(
        self,
        path: str,
        ids: Optional[np.ndarray] = None,
        attributes: Optional[Dict[str, np.ndarray]] = None,
        n_shards: int = 10,
        overwrite: bool = False,
    ):
        self._path = path
        self._file = None
        if ids is not None:
            if attributes is None:
                raise ValueError("attributes required when building a store.")
            self._build(np.asarray(ids), attributes, n_shards, overwrite)
        else:
            self._open()

    # ------------------------------------------------------------------ build
    def _build(self, ids: np.ndarray, attributes: Dict[str, np.ndarray], n_shards: int,
               overwrite: bool):
        if os.path.isfile(self._path):
            if not overwrite:
                raise FileExistsError(self._path)
            os.remove(self._path)
        order = np.argsort(ids, kind="stable")
        ids_sorted = ids[order]
        bounds = np.linspace(0, len(ids_sorted), n_shards + 1).astype(np.int64)
        arrays = {
            "n_shards": np.int64(n_shards),
            "n_elements": np.int64(len(ids_sorted)),
            # first id of each shard, for the shard lookup
            "shard_starts": ids_sorted[np.minimum(bounds[:-1], len(ids_sorted) - 1)]
            if len(ids_sorted) else np.zeros(n_shards, ids.dtype),
            "bounds": bounds,
        }
        for si in range(n_shards):
            sl = slice(bounds[si], bounds[si + 1])
            arrays[f"shard_{si}/ids"] = ids_sorted[sl]
            for key, vals in attributes.items():
                arrays[f"shard_{si}/{key}"] = np.asarray(vals)[order][sl]
        d = os.path.dirname(self._path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{self._path}.tmp{os.getpid()}.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, self._path)
        self._open()

    def _open(self):
        self._file = np.load(self._path, allow_pickle=False)

    # ------------------------------------------------------------------ query
    @property
    def n_shards(self) -> int:
        return int(self._file["n_shards"])

    @property
    def id_array(self) -> np.ndarray:
        return np.concatenate([self._file[f"shard_{si}/ids"] for si in range(self.n_shards)])

    @property
    def attr_names(self):
        return [k.split("/", 1)[1] for k in self._file.files
                if k.startswith("shard_0/") and k != "shard_0/ids"]

    def get_attributes(self, ids: np.ndarray, attr_key: str) -> np.ndarray:
        """Look up ``attr_key`` for each query id (which must be stored)."""
        ids = np.asarray(ids)
        out = None
        shard_starts = self._file["shard_starts"]
        shard_ix = np.searchsorted(shard_starts, ids, side="right") - 1
        shard_ix = np.clip(shard_ix, 0, self.n_shards - 1)
        for si in np.unique(shard_ix):
            sel = shard_ix == si
            sids = self._file[f"shard_{int(si)}/ids"]
            vals = self._file[f"shard_{int(si)}/{attr_key}"]
            if len(sids) == 0:
                raise KeyError("Empty shard queried.")
            pos = np.clip(np.searchsorted(sids, ids[sel]), 0, len(sids) - 1)
            if not np.all(sids[pos] == ids[sel]):
                missing = ids[sel][sids[pos] != ids[sel]]
                raise KeyError(f"IDs not found in store: {missing[:10]} ...")
            if out is None:
                out = np.empty(len(ids), dtype=vals.dtype)
            out[sel] = vals[pos]
        if out is None:
            out = np.zeros(0, dtype=np.uint64)
        return out

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_file"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._open()

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None
