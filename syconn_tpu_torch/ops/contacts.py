"""Contact-site detection on the host: boundary masks, the exact stencil
majority-partner vote and per-contact synapse statistics (counterpart of
``syconn_tpu/ops/contacts.py``).

* :func:`detect_seg_boundaries` — 6-neighborhood boundary mask.
* :func:`detect_cs` — valid-convolution scan: for every boundary voxel the
  most frequent foreign ID in the stencil window (the active config's
  ``cs_filtersize`` by default) is selected (ties -> smallest ID) and the
  sorted ID pair is packed into one uint64 (``min << 32 | max``).
* :func:`detect_cs_64bit`, :func:`detect_contact_partners` — the same vote
  for uint64 ids, the (low, high) pair in a last axis of 2.
* :func:`extract_cs_syntype` — per-contact-site synapse stats (syn voxel
  coords, sym/asym counts).
* :func:`relabel_vol`, :func:`relabel_vol_nonexist2zero` — label remaps
  through a dict (host library hash map, else ``searchsorted``).

``detect_cs`` is the exact reference of the device formulations
(:mod:`.contacts_cuda`, :mod:`.contacts_torch`); they call it for what they
cannot take: columns or tiles with more labels than their candidate table,
and chunks with ids of 2**31 and above. It runs in the C++ host library
(:mod:`syconn_tpu_torch.utils.native`) when that builds, else in numpy.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..utils.native import get_native
from .props import object_properties_arrays, pair_counts

__all__ = [
    "cs_pair_pack",
    "cs_pair_unpack",
    "detect_seg_boundaries",
    "detect_cs",
    "detect_cs_64bit",
    "detect_contact_partners",
    "extract_cs_syntype",
    "relabel_vol",
    "relabel_vol_nonexist2zero",
]


def cs_pair_pack(id_lo: np.ndarray, id_hi: np.ndarray) -> np.ndarray:
    """Pack a sorted partner pair into one uint64 (smaller ID in high bits)."""
    return (np.asarray(id_lo, np.uint64) << np.uint64(32)) | np.asarray(id_hi, np.uint64)


def cs_pair_unpack(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    packed = np.asarray(packed, np.uint64)
    return packed >> np.uint64(32), packed & np.uint64(0xFFFFFFFF)


def detect_seg_boundaries(arr: np.ndarray) -> np.ndarray:
    """Boolean mask of nonzero voxels with a differing 6-neighbor."""
    arr = np.ascontiguousarray(arr)
    lib = get_native()
    if lib is not None and arr.dtype in (np.uint32, np.uint64) and arr.size > 4096:
        out = np.empty(arr.shape, dtype=np.uint8)
        fn = (lib.detect_seg_boundaries_u32 if arr.dtype == np.uint32
              else lib.detect_seg_boundaries_u64)
        fn(arr, arr.shape[0], arr.shape[1], arr.shape[2], out)
        return out.astype(bool)
    return _detect_seg_boundaries_np(arr)


def _detect_seg_boundaries_np(arr: np.ndarray) -> np.ndarray:
    bdry = np.zeros(arr.shape, dtype=bool)
    for ax in range(3):
        sl_a = [slice(None)] * 3
        sl_b = [slice(None)] * 3
        sl_a[ax] = slice(1, None)
        sl_b[ax] = slice(None, -1)
        diff = arr[tuple(sl_a)] != arr[tuple(sl_b)]
        bdry[tuple(sl_a)] |= diff
        bdry[tuple(sl_b)] |= diff
    bdry &= arr != 0
    return bdry


def _stencil_from_config(stencil) -> np.ndarray:
    """``stencil``, or the active config's ``cell_objects.cs_filtersize``
    when it is None; every extent must be odd."""
    if stencil is None:
        from .. import global_params

        stencil = global_params.config["cell_objects"]["cs_filtersize"]
    stencil = np.asarray(stencil, dtype=np.int32)
    if not np.all(stencil % 2 == 1):
        raise ValueError(f"stencil must be odd, got {tuple(stencil)}")
    return stencil


def detect_cs(arr: np.ndarray, stencil=None) -> np.ndarray:
    """Contact-site detection for uint32 segmentation; packed uint64 output
    of valid-convolution shape ``arr.shape - stencil + 1``."""
    stencil = _stencil_from_config(stencil)
    arr = np.ascontiguousarray(arr, dtype=np.uint32)
    bdry = detect_seg_boundaries(arr).astype(np.uint8)
    lib = get_native()
    if lib is None:
        return _detect_cs_np(arr, bdry, stencil, packed=True)
    out = np.empty(tuple(np.array(arr.shape) - stencil + 1), dtype=np.uint64)
    lib.detect_cs_u32(arr, np.ascontiguousarray(bdry), arr.shape[0], arr.shape[1],
                      arr.shape[2], int(stencil[0]), int(stencil[1]), int(stencil[2]), out)
    return out


def detect_cs_64bit(arr: np.ndarray, stencil=None) -> np.ndarray:
    """64-bit form of :func:`detect_cs`: a (x, y, z, 2) uint64 array of the
    (low ID, high ID) partner pair instead of a packed uint64."""
    stencil = _stencil_from_config(stencil)
    arr = np.ascontiguousarray(arr, dtype=np.uint64)
    bdry = detect_seg_boundaries(arr).astype(np.uint8)
    return _contact_partners(arr, bdry, stencil)


def detect_contact_partners(seg_arr, edge_arr, offset) -> np.ndarray:
    """Reference-shaped form (find_object_properties.py:370) on a given
    boundary mask ``edge_arr``; ``offset`` is a (3, 2) array of
    (-half, +half) window extents."""
    offset = np.asarray(offset)
    stencil = (offset[:, 1] - offset[:, 0] + 1).astype(np.int32)
    arr = np.ascontiguousarray(seg_arr, dtype=np.uint64)
    return _contact_partners(arr, np.ascontiguousarray(edge_arr, dtype=np.uint8), stencil)


def _contact_partners(arr: np.ndarray, bdry: np.ndarray, stencil: np.ndarray) -> np.ndarray:
    lib = get_native()
    if lib is None:
        return _detect_cs_np(arr, bdry, stencil, packed=False)
    out = np.empty(tuple(np.array(arr.shape) - stencil + 1) + (2,), dtype=np.uint64)
    lib.detect_contact_partners_u64(arr, bdry, arr.shape[0], arr.shape[1], arr.shape[2],
                                    int(stencil[0]), int(stencil[1]), int(stencil[2]), out)
    return out


def _detect_cs_np(arr, bdry, stencil, packed: bool) -> np.ndarray:
    """Exact numpy version: iterates boundary voxels only. ``packed`` gives
    one uint64 a voxel, else the (low, high) pair in a last axis of 2."""
    off = stencil // 2
    out_shape = tuple(np.array(arr.shape) - stencil + 1)
    out = np.zeros(out_shape if packed else out_shape + (2,), dtype=np.uint64)
    core = bdry[off[0]:arr.shape[0] - off[0], off[1]:arr.shape[1] - off[1],
                off[2]:arr.shape[2] - off[2]]
    for x, y, z in np.argwhere(core):
        center = arr[x + off[0], y + off[1], z + off[2]]
        win = arr[x:x + stencil[0], y:y + stencil[1], z:z + stencil[2]]
        ids, counts = np.unique(win, return_counts=True)
        sel = (ids != 0) & (ids != center)
        ids, counts = ids[sel], counts[sel]
        if len(ids) == 0:
            continue
        best = ids[np.argmax(counts)]  # unique() ascending -> ties pick smallest
        lo, hi = (center, best) if center < best else (best, center)
        if packed:
            out[x, y, z] = (np.uint64(lo) << np.uint64(32)) | np.uint64(hi)
        else:
            out[x, y, z] = lo, hi
    return out


def extract_cs_syntype(cs_seg: np.ndarray, syn_mask: np.ndarray, asym_mask: np.ndarray,
                       sym_mask: np.ndarray, offset=(0, 0, 0)):
    """Synaptic properties per contact-site ID.

    Returns ``(cs_props, syn_props, cs_asym, cs_sym, voxels_syn)`` where the
    prop entries are ``[rep_coords, bounding_boxes, sizes]`` dicts, the
    count entries map cs_id -> #sym/#asym voxels within the synaptic
    foreground, and voxels_syn maps cs_id -> (N, 3) global syn voxel coords.
    """
    offset = np.asarray(offset, dtype=np.int64)
    ids, rep, bbs, sizes = object_properties_arrays(cs_seg)
    cs_props = (
        {int(i): rep[k] for k, i in enumerate(ids)},
        {int(i): bbs[k] for k, i in enumerate(ids)},
        {int(i): int(sizes[k]) for k, i in enumerate(ids)},
    )
    syn_fg = cs_seg * (np.asarray(syn_mask) != 0)
    ids_s, rep_s, bbs_s, sizes_s = object_properties_arrays(syn_fg)
    syn_props = (
        {int(i): rep_s[k] for k, i in enumerate(ids_s)},
        {int(i): bbs_s[k] for k, i in enumerate(ids_s)},
        {int(i): int(sizes_s[k]) for k, i in enumerate(ids_s)},
    )
    # per-CS syn voxel coordinate lists (global frame)
    voxels_syn: Dict[int, np.ndarray] = {}
    if len(ids_s):
        flat = syn_fg.reshape(-1)
        nz = np.flatnonzero(flat)
        vals = flat[nz]
        order = np.argsort(vals, kind="stable")
        svals, snz = vals[order], nz[order]
        uq, starts = np.unique(svals, return_index=True)
        ends = np.append(starts[1:], len(svals))
        for k, i in enumerate(uq):
            coords = np.stack(
                np.unravel_index(snz[starts[k]:ends[k]], cs_seg.shape), axis=1
            ).astype(np.int64)
            voxels_syn[int(i)] = coords + offset[None]
    # sym/asym counts inside the synaptic foreground
    a_ids, _, a_cnt = pair_counts(syn_fg, (np.asarray(asym_mask) == 1).astype(np.uint8))
    s_ids, _, s_cnt = pair_counts(syn_fg, (np.asarray(sym_mask) == 1).astype(np.uint8))
    cs_asym = {int(i): int(c) for i, c in zip(a_ids, a_cnt)}
    cs_sym = {int(i): int(c) for i, c in zip(s_ids, s_cnt)}
    return cs_props, syn_props, cs_asym, cs_sym, voxels_syn


def relabel_vol(vol: np.ndarray, label_map: Dict[int, int]) -> np.ndarray:
    """In-place label remap; labels missing from the map are kept."""
    return _relabel(vol, label_map, nonexist2zero=False)


def relabel_vol_nonexist2zero(vol: np.ndarray, label_map: Dict[int, int]) -> np.ndarray:
    """In-place label remap; labels missing from the map become 0."""
    return _relabel(vol, label_map, nonexist2zero=True)


def _relabel(vol: np.ndarray, label_map: Dict[int, int], nonexist2zero: bool) -> np.ndarray:
    if not vol.flags.c_contiguous or not vol.flags.writeable:
        vol = np.ascontiguousarray(vol).copy()
    lib = get_native()
    if lib is not None and vol.dtype in (np.uint32, np.uint64) and len(label_map) > 0:
        keys = np.fromiter(label_map.keys(), dtype=vol.dtype, count=len(label_map))
        vals = np.fromiter(label_map.values(), dtype=vol.dtype, count=len(label_map))
        fn = lib.relabel_u32 if vol.dtype == np.uint32 else lib.relabel_u64
        fn(vol.reshape(-1), vol.size, keys, vals, len(keys), int(nonexist2zero))
        return vol
    if len(label_map) == 0:
        if nonexist2zero:
            vol[...] = 0
        return vol
    keys = np.array(sorted(label_map.keys()), dtype=vol.dtype)
    vals = np.array([label_map[int(k)] for k in keys], dtype=vol.dtype)
    flat = vol.reshape(-1)
    pos = np.clip(np.searchsorted(keys, flat), 0, len(keys) - 1)
    hit = keys[pos] == flat
    vol[...] = np.where(hit, vals[pos], 0 if nonexist2zero else flat).reshape(vol.shape)
    return vol
