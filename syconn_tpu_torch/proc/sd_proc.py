"""SegmentationDataset generation: the fused property and mapping scan
(counterpart of ``syconn_tpu/proc/sd_proc.py``, up to its write phase).

One pass over the volume per chunk yields, for the cell supervoxels and
every organelle type at once: per-id size, bounding box and representative
coordinate, and the organelle -> cell overlap counts. Chunk results merge
through sorted segmented reductions (``ops.props.merge_prop_arrays``).

The cell segmentation is scanned on the device when ``io.resident`` holds
it (:class:`..ops.props_torch.ResidentPropsScanner`), else on the host; the
organelle segmentations and the overlap counts are scanned on the host, as
in the JAX package. Not ported yet: the write phase (``_write_type``: the
per-shard ``AttributeDict``/``MeshStorage``/``VoxelStorageDyn`` stores and
numpy caches of a ``SegmentationDataset``), meshes (``find_meshes``) and
``dataset_analysis``; :func:`map_subcell_extract_props_tables` returns what
the write phase receives.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np

from ..io import resident
from ..io.chunked import ChunkedVolume
from ..ops.props import merge_prop_arrays, object_properties_arrays, pair_counts
from ..ops.props_torch import ResidentPropsScanner
from ..utils.device import default_device
from ..utils.stepcache import StepCache, cached_map

log = logging.getLogger("syconn_tpu_torch.sd_proc")

__all__ = ["map_subcell_extract_props_tables"]


def _cdiv(a, b):
    return -(-a // b)


def map_subcell_extract_props_tables(
    kd_seg_path: str,
    kd_organelle_paths: Dict[str, str],
    chunk_shape: Sequence[int] = (256, 256, 128),
    min_obj_vx: Optional[Dict[str, int]] = None,
    n_workers: Optional[int] = None,
    mag: int = 1,
    cache_root: Optional[str] = None,
    overwrite: bool = True,
    device=None,
) -> Dict:
    """Property tables of the cell segmentation ('sv') and every organelle
    type, and the organelle -> cell overlap counts, in one volume scan.

    ``min_obj_vx``: type -> smallest object kept (default 1). ``cache_root``
    holds the per-chunk resume cache (default: the segmentation's parent
    directory); ``overwrite=False`` resumes a crashed scan per chunk.
    ``device``: None means the CUDA card (required); ``"cpu"`` runs the
    device scan's ops on the CPU.

    Returns ``tables`` (type -> (ids, rep_coords, bounding_boxes, sizes),
    ascending ids, objects under ``min_obj_vx`` dropped), ``mapping``
    (organelle -> {organelle id: {cell id: voxels}}), ``sc_sizes``
    (organelle -> {id: size}, before the size filter: the denominators of
    the cells' reverse mapping ratios), ``counts`` (type -> objects kept)
    and ``stats``: the cell scan's ``cell_route`` (``"resident"`` or
    ``"host"``), ``chunks``, ``resumed``, ``seconds`` (the call) and the
    thread-seconds of ``load_seconds``, ``cell_scan_seconds``,
    ``organelle_scan_seconds`` and ``pair_seconds``.
    """
    default_device(device)
    t_start = time.perf_counter()
    kd = ChunkedVolume.open(kd_seg_path)
    sh = kd.mag_shape(mag)
    cs = np.minimum(np.asarray(chunk_shape, np.int64), sh)
    grid = _cdiv(sh, cs)
    organelles = list(kd_organelle_paths.keys())
    kd_orgs = {co: ChunkedVolume.open(p) for co, p in kd_organelle_paths.items()}
    min_obj_vx = dict(min_obj_vx or {})
    chunk_ixs = [(cx, cy, cz) for cx in range(grid[0]) for cy in range(grid[1])
                 for cz in range(grid[2])]
    stage = {"load_seconds": 0.0, "cell_scan_seconds": 0.0, "organelle_scan_seconds": 0.0,
             "pair_seconds": 0.0}
    stage_lock = threading.Lock()

    # a cell segmentation held in device memory: the per-chunk scan (a sort
    # of every voxel of a dense chunk) runs on the device from its windows
    res_scanner = None
    res_cell = resident.get(kd_seg_path, "seg", mag) if mag == 1 else None
    if res_cell is not None:
        res_scanner = ResidentPropsScanner(res_cell, chunk=tuple(int(c) for c in cs))

    def work_chunk(cix):
        off = np.array(cix) * cs
        size = np.minimum(cs, sh - off)
        t0 = time.perf_counter()
        cell = kd.load_seg(offset=off, size=size, mag=mag)
        t1 = time.perf_counter()
        res = {"off": off, "pairs": {}, "sc": {}}
        res["sv"] = res_scanner.props(cix) if res_scanner is not None \
            else object_properties_arrays(cell)
        t2 = time.perf_counter()
        t_load = t_scan = t_pair = 0.0
        for co in organelles:
            ta = time.perf_counter()
            sc = kd_orgs[co].load_seg(offset=off, size=size, mag=mag)
            tb = time.perf_counter()
            res["sc"][co] = object_properties_arrays(sc)
            tc = time.perf_counter()
            res["pairs"][co] = pair_counts(sc, cell)
            td = time.perf_counter()
            t_load += tb - ta
            t_scan += tc - tb
            t_pair += td - tc
        with stage_lock:
            stage["load_seconds"] += t1 - t0 + t_load
            stage["cell_scan_seconds"] += t2 - t1
            stage["organelle_scan_seconds"] += t_scan
            stage["pair_seconds"] += t_pair
        return res

    if cache_root is None:
        cache_root = os.path.dirname(os.path.abspath(os.path.normpath(kd_seg_path)))
    cache = StepCache("sd_props", cache_root, overwrite=overwrite)
    key = lambda c: f"{c[0]}_{c[1]}_{c[2]}"  # noqa: E731
    n_resumed = sum(1 for c in chunk_ixs if cache.done(key(c)))
    chunk_results = cached_map(work_chunk, chunk_ixs, cache, key_fn=key, n_workers=n_workers)

    merged = {}
    for t in ["sv"] + organelles:
        parts = [r["sv"] if t == "sv" else r["sc"][t] for r in chunk_results]
        # chunk-local coordinates -> the global frame before the merge
        merged[t] = _merge_with_offsets(parts, [r["off"] for r in chunk_results])
    mapping: Dict[str, Dict[int, Dict[int, int]]] = {co: defaultdict(dict) for co in organelles}
    for r in chunk_results:
        for co in organelles:
            mp = mapping[co]
            for sc_id, c_id, cnt in zip(*r["pairs"][co]):
                d = mp[int(sc_id)]
                d[int(c_id)] = d.get(int(c_id), 0) + int(cnt)
    del chunk_results
    sc_sizes = {co: dict(zip((int(i) for i in merged[co][0]), (int(s) for s in merged[co][3])))
                for co in organelles}
    tables, counts = {}, {}
    for t in ["sv"] + organelles:
        ids, rep, bb, sz = merged[t]
        keep = sz >= int(min_obj_vx.get(t, 1))
        tables[t] = (ids[keep], rep[keep], bb[keep], sz[keep])
        counts[t] = int(keep.sum())
    cache.mark_complete()
    stats = {"cell_route": "resident" if res_scanner is not None else "host",
             "chunks": len(chunk_ixs), "resumed": n_resumed,
             "seconds": time.perf_counter() - t_start, **stage}
    log.info("SD property scan done: %s", counts)
    return {"tables": tables, "mapping": {co: dict(m) for co, m in mapping.items()},
            "sc_sizes": sc_sizes, "counts": counts, "stats": stats}


def _merge_with_offsets(parts, offsets):
    shifted = []
    for (ids, rep, bb, sz), off in zip(parts, offsets):
        off = np.asarray(off, np.int64)
        shifted.append((ids, rep + off[None], bb + off[None, None], sz))
    return merge_prop_arrays(shifted)
