"""Representation helpers: the sharded storage layout (counterpart of
``syconn_tpu/reps/rep_helper.py``). Object-ID -> storage-shard hashing
(``subfold_from_ix_new`` groups consecutive 1000-ID blocks into the same
shard, ``subfold_from_ix_OLD`` is digit-based), the inverse
``ix_from_subfold``, ``get_unique_subfold_ixs``, ``surface_samples`` and
the working-directory plumbing of the dataset classes, and
``colorcode_vertices`` (labels onto mesh vertices by k-nearest majority, for
the spine-head volumes of step 7) and ``knossos_ml_from_sso`` (a cell's
KNOSSOS merge list, for the kzip export). ``assign_rep_values`` comes with
the item that uses it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import spatial

__all__ = [
    "subfold_from_ix",
    "subfold_from_ix_new",
    "subfold_from_ix_OLD",
    "ix_from_subfold",
    "ix_from_subfold_new",
    "ix_from_subfold_OLD",
    "get_unique_subfold_ixs",
    "surface_samples",
    "colorcode_vertices",
    "knossos_ml_from_sso",
    "SegmentationBase",
]

_DIV_BASE = 1000  # consecutive-ID block size mapped to one shard


def subfold_from_ix(ix: int, n_folders: int, old_version: bool = False) -> str:
    """Storage subfolder for object ``ix`` given ``n_folders`` shards."""
    assert n_folders % 10 == 0
    from .. import global_params

    if global_params.config.use_new_subfold:
        return subfold_from_ix_new(ix, n_folders)
    return subfold_from_ix_OLD(ix, n_folders, old_version)


def subfold_from_ix_new(ix: int, n_folders: int) -> str:
    """Block scheme: consecutive 1000-ID ranges share a shard, spread
    round-robin over ``n_folders`` folders; two digits per path level."""
    assert n_folders % 10 == 0
    order = int(np.log10(n_folders))
    shard = int(ix // _DIV_BASE % n_folders)
    digits = f"{shard:0{order}d}"
    return "/" + "".join(digits[i : i + 2] + "/" for i in range(0, order, 2))


def subfold_from_ix_OLD(ix: int, n_folders: int, old_version: bool = False) -> str:
    """Digit scheme: shard by the trailing decimal digits of the ID."""
    assert n_folders in [10**i for i in range(6)]
    order = int(np.log10(n_folders))
    id_str = "00000" + str(int(ix))
    subfold = "/"
    for f_order in range(0, order, 2):
        idx = len(id_str) - order + f_order
        subfold += id_str[idx : idx + 2] + "/"
    if old_version:
        subfold = subfold.replace("/0", "/").replace("//", "/0/")
    return subfold


def ix_from_subfold(subfold: str, n_folders: int) -> int:
    from .. import global_params

    if global_params.config.use_new_subfold:
        return ix_from_subfold_new(subfold, n_folders)
    return ix_from_subfold_OLD(subfold, n_folders)


def ix_from_subfold_new(subfold: str, n_folders: int) -> int:
    """Representative ID of a shard folder (first ID of its lowest block)."""
    parts = subfold.strip("/").split("/")
    order = int(np.log10(n_folders))
    if order % 2 == 0:
        shard_str = "".join(f"{int(p):02d}" for p in parts)
    else:
        shard_str = "".join(f"{int(p):02d}" for p in parts[:-1]) + parts[-1]
    return int(int(shard_str) * _DIV_BASE)


def ix_from_subfold_OLD(subfold: str, n_folders: int) -> int:
    parts = subfold.strip("/").split("/")
    order = int(np.log10(n_folders))
    if order % 2 == 0:
        return int("".join(f"{int(p):02d}" for p in parts))
    return int("".join(f"{int(p):02d}" for p in parts[:-1]) + parts[-1])


def get_unique_subfold_ixs(n_folders: int) -> np.ndarray:
    """One representative object ID per storage shard."""
    from .. import global_params

    if global_params.config.use_new_subfold:
        return np.array([ix * _DIV_BASE for ix in range(n_folders)], dtype=np.uint64)
    return np.arange(n_folders, dtype=np.uint64)


def surface_samples(
    coords: np.ndarray,
    bin_sizes=(2000, 2000, 2000),
    max_nb_samples: Optional[int] = 5000,
    r: float = 1000,
) -> np.ndarray:
    """Sample locations from a vertex cloud by density-grid binning
    (rendering-location sampling)."""
    coords = np.asarray(coords, dtype=np.float32)
    if len(coords) == 0:
        return np.zeros((0, 3), dtype=np.float32)
    bin_sizes = np.asarray(bin_sizes, dtype=np.float32)
    lo = coords.min(axis=0)
    cell_ix = np.floor((coords - lo) / bin_sizes).astype(np.int64)
    # unique occupied cells; pick the vertex closest to each cell center
    keys = (
        cell_ix[:, 0] * 73856093 ^ cell_ix[:, 1] * 19349663 ^ cell_ix[:, 2] * 83492791
    )
    _, first_ix = np.unique(keys, return_index=True)
    samples = coords[first_ix]
    if max_nb_samples is not None and len(samples) > max_nb_samples:
        sel = np.linspace(0, len(samples) - 1, max_nb_samples).astype(np.int64)
        samples = samples[sel]
    return samples


def colorcode_vertices(
    vertices: np.ndarray,
    rep_coords: np.ndarray,
    rep_values: np.ndarray,
    colors: Optional[np.ndarray] = None,
    nb_cpus: int = 1,
    k: int = 1,
    return_color: bool = True,
) -> np.ndarray:
    """Map per-location labels to mesh vertices via (k-)nearest neighbor.

    With ``k > 1`` a majority vote over the k nearest rep coords is used.
    Returns colors (``colors[label]``) or the raw per-vertex labels.
    """
    rep_values = np.asarray(rep_values)
    tree = spatial.cKDTree(np.asarray(rep_coords))
    _, ixs = tree.query(np.asarray(vertices), k=k, workers=nb_cpus)
    if k == 1:
        labels = rep_values[ixs]
    else:
        neigh = rep_values[ixs.reshape(len(vertices), k)]
        labels = np.array(
            [np.bincount(row.astype(np.int64)).argmax() for row in neigh],
            dtype=rep_values.dtype,
        )
    if not return_color or colors is None:
        return labels
    colors = np.asarray(colors)
    return colors[labels]


def knossos_ml_from_sso(sso, comment: Optional[str] = None) -> str:
    """KNOSSOS merge-list text of one cell: ``"<id> 0 <comment> <sv ids>"``
    and its rep coord, as the JAX package writes it."""
    sv_ids = np.array(sso.sv_ids, dtype=np.uint64)
    txt = f"{sso.id} 0 {comment or ''} "
    txt += " ".join(str(ix) for ix in sv_ids)
    cc = np.array(sso.rep_coord, dtype=np.int64)
    txt += f"\n{cc[0]} {cc[1]} {cc[2]}\n\n\n"
    return txt


class SegmentationBase:
    """Shared working-dir / config plumbing for dataset classes."""

    def _setup_working_dir(self, working_dir, config, version, scaling):
        from .. import global_params
        from ..handler.config import Config

        if working_dir is None and config is not None:
            working_dir = config.working_dir
        if working_dir is None:
            working_dir = global_params.config.working_dir
        self._working_dir = working_dir
        if config is None:
            if (
                global_params.config.working_dir is not None
                and global_params.config.working_dir == working_dir
            ):
                config = global_params.config
            else:
                config = Config(working_dir) if working_dir else None
        self._config = config
        if scaling is None and config is not None:
            scaling = np.array(config["scaling"], dtype=np.float32)
        self._scaling = scaling

    @property
    def working_dir(self):
        return self._working_dir

    @property
    def config(self):
        return self._config

    @property
    def scaling(self) -> np.ndarray:
        return np.asarray(self._scaling, dtype=np.float32)
