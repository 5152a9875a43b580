"""Per-object property extraction from label volumes (counterpart of
``syconn_tpu/ops/props.py``; numpy only).

The volume is flattened, stably sorted by ID, and per-ID statistics (size,
bounding box, first-occurrence representative coordinate) come from
segmented reductions.

Semantics:
* background ID 0 is never extracted,
* ``bb = [coord_min, coord_max + 1]``,
* the representative coordinate is the object's first voxel in C scan order.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = [
    "object_properties_arrays",
    "find_object_properties",
    "pair_counts",
    "map_subcell_extract_props",
    "merge_prop_arrays",
]


def object_properties_arrays(
    chunk: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized per-ID stats of a 3D label volume.

    Returns:
        ids: (K,) unique nonzero IDs (ascending).
        rep_coords: (K, 3) first-occurrence voxel per ID (C scan order).
        bbs: (K, 2, 3) bounding boxes ``[min, max + 1]``.
        sizes: (K,) voxel counts.
    """
    chunk = np.ascontiguousarray(chunk)
    flat = chunk.reshape(-1)
    nz_ix = np.flatnonzero(flat)
    if len(nz_ix) == 0:
        return (
            np.zeros(0, dtype=chunk.dtype),
            np.zeros((0, 3), dtype=np.int64),
            np.zeros((0, 2, 3), dtype=np.int64),
            np.zeros(0, dtype=np.int64),
        )
    ids = flat[nz_ix]
    order = np.argsort(ids, kind="stable")
    sids = ids[order]
    six = nz_ix[order]
    uniq, starts, counts = np.unique(sids, return_index=True, return_counts=True)
    coords = np.stack(np.unravel_index(six, chunk.shape), axis=1).astype(np.int64)
    mins = np.minimum.reduceat(coords, starts, axis=0)
    maxs = np.maximum.reduceat(coords, starts, axis=0) + 1
    bbs = np.stack([mins, maxs], axis=1)
    rep = coords[starts]
    return uniq, rep, bbs, counts.astype(np.int64)


def find_object_properties(chunk: np.ndarray) -> Tuple[Dict, Dict, Dict]:
    """Dict-API parity wrapper (reference: find_object_properties_C.pyx:24).

    Returns ``(rep_coords, bounding_boxes, sizes)`` keyed by object ID.
    """
    ids, rep, bbs, sizes = object_properties_arrays(chunk)
    rep_dc = {}
    bb_dc = {}
    size_dc = {}
    for i, oid in enumerate(ids):
        key = int(oid)
        rep_dc[key] = rep[i]
        bb_dc[key] = bbs[i]
        size_dc[key] = int(sizes[i])
    return rep_dc, bb_dc, size_dc


def pair_counts(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Co-occurrence counts of nonzero (a, b) label pairs.

    Returns ``(a_ids, b_ids, counts)`` for every pair where both labels are
    nonzero at the same voxel — the overlap counting that drives
    organelle -> cell mapping (reference: find_object_properties_C.pyx:72).
    """
    mask = (a != 0) & (b != 0)
    av = a[mask].astype(np.uint64)
    bv = b[mask].astype(np.uint64)
    if len(av) == 0:
        return (
            np.zeros(0, np.uint64),
            np.zeros(0, np.uint64),
            np.zeros(0, np.int64),
        )
    if av.max() < 2**32 and bv.max() < 2**32:
        packed = (av << np.uint64(32)) | bv
        uniq, counts = np.unique(packed, return_counts=True)
        return uniq >> np.uint64(32), uniq & np.uint64(0xFFFFFFFF), counts.astype(np.int64)
    # > 32-bit IDs: lexsort path
    order = np.lexsort((bv, av))
    av, bv = av[order], bv[order]
    new = np.empty(len(av), dtype=bool)
    new[0] = True
    new[1:] = (av[1:] != av[:-1]) | (bv[1:] != bv[:-1])
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, len(av)))
    return av[starts], bv[starts], counts.astype(np.int64)



def map_subcell_extract_props(
    cell: np.ndarray, subcell_stack: np.ndarray
) -> Tuple[List, List, List]:
    """Fused cell + organelle property scan with overlap mapping
    (reference: find_object_properties_C.pyx:112).

    Args:
        cell: 3D cell supervoxel labels.
        subcell_stack: (n_organelles, x, y, z) organelle labels.

    Returns:
        ``[cell_rep, cell_bb, cell_sizes]`` (dicts keyed by ID),
        ``[sc_rep_list, sc_bb_list, sc_size_list]`` (one dict per organelle),
        ``mapping_list`` (per organelle: ``{subcell_id: {cell_id: count}}``).
    """
    cell_props = list(find_object_properties(cell))
    sc_rep, sc_bb, sc_sz, mappings = [], [], [], []
    for ii in range(subcell_stack.shape[0]):
        sc = subcell_stack[ii]
        r, b, s = find_object_properties(sc)
        sc_rep.append(r)
        sc_bb.append(b)
        sc_sz.append(s)
        a_ids, c_ids, cnts = pair_counts(sc, cell)
        mp: Dict[int, Dict[int, int]] = {}
        for sc_id, c_id, cnt in zip(a_ids, c_ids, cnts):
            mp.setdefault(int(sc_id), {})[int(c_id)] = int(cnt)
        mappings.append(mp)
    return cell_props, [sc_rep, sc_bb, sc_sz], mappings


def merge_prop_arrays(parts, offsets=None):
    """Merge per-chunk (ids, rep, bb, size) tuples into global arrays.

    ``offsets[i]`` (xyz) shifts chunk-local coordinates into the global
    frame (reference reduce step: sd_proc.py:1248 ``merge_prop_dicts``).
    Returns merged (ids, rep, bb, size) with one row per unique ID.
    """
    all_ids, all_rep, all_bb, all_sz = [], [], [], []
    for i, (ids, rep, bb, sz) in enumerate(parts):
        if len(ids) == 0:
            continue
        off = np.zeros(3, np.int64) if offsets is None else np.asarray(offsets[i], np.int64)
        all_ids.append(ids.astype(np.uint64))
        all_rep.append(rep + off[None])
        all_bb.append(bb + off[None, None])
        all_sz.append(sz)
    if not all_ids:
        return (
            np.zeros(0, np.uint64),
            np.zeros((0, 3), np.int64),
            np.zeros((0, 2, 3), np.int64),
            np.zeros(0, np.int64),
        )
    ids = np.concatenate(all_ids)
    rep = np.concatenate(all_rep)
    bb = np.concatenate(all_bb)
    sz = np.concatenate(all_sz)
    order = np.argsort(ids, kind="stable")
    ids, rep, bb, sz = ids[order], rep[order], bb[order], sz[order]
    uniq, starts = np.unique(ids, return_index=True)
    ends = np.append(starts[1:], len(ids))
    out_rep = rep[starts]  # first chunk's rep coord wins (reference semantics)
    out_min = np.minimum.reduceat(bb[:, 0], starts, axis=0)
    out_max = np.maximum.reduceat(bb[:, 1], starts, axis=0)
    out_sz = np.add.reduceat(sz, starts)
    return uniq, out_rep, np.stack([out_min, out_max], axis=1), out_sz
