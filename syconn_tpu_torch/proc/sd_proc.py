"""SegmentationDataset generation: the fused property, mapping and mesh
scan and the write phase (counterpart of ``syconn_tpu/proc/sd_proc.py``).

One pass over the volume per chunk yields, for the cell supervoxels and
every organelle type at once: per-id size, bounding box and representative
coordinate, the organelle -> cell overlap counts and, when asked for,
surface-net mesh fragments. Chunk results merge through sorted segmented
reductions (``ops.props.merge_prop_arrays``);
:func:`map_subcell_extract_props_tables` returns the merged tables, and
:func:`map_subcell_extract_props` writes them as ``SegmentationDataset``s
(per-shard ``AttributeDict``/``MeshStorage``/``VoxelStorageDyn`` stores and
numpy caches, :func:`_write_type`).

The cell segmentation is scanned on the device when ``io.resident`` holds
it (:class:`..ops.props_torch.ResidentPropsScanner`), else on the host; the
organelle segmentations, the overlap counts and the meshes are computed on
the host, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import global_params
from ..backend import AttributeDict, MeshStorage, VoxelStorageDyn
from ..io import resident
from ..io.chunked import ChunkedVolume
from ..ops.props import merge_prop_arrays, object_properties_arrays, pair_counts
from ..ops.props_torch import ResidentPropsScanner
from ..parallel.executor import map_parallel
from ..reps.rep_helper import subfold_from_ix
from ..reps.segmentation import SegmentationDataset
from ..utils.device import default_device
from ..utils.stepcache import StepCache, cached_map
from .meshes import find_meshes, merge_meshes

log = logging.getLogger("syconn_tpu_torch.sd_proc")

__all__ = ["map_subcell_extract_props", "map_subcell_extract_props_tables",
           "dataset_analysis", "sd_init"]


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
    mesh_downsampling: Optional[Dict[str, Sequence[int]]] = None,
    generate_sv_meshes: bool = True,
) -> Dict:
    """Property tables of the cell segmentation ('sv') and every organelle
    type, and the organelle -> cell overlap counts, in one volume scan.
    With ``mesh_downsampling`` (type -> stride) each chunk's objects are
    meshed too (the cells' only if ``generate_sv_meshes``).

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
             "pair_seconds": 0.0, "mesh_seconds": 0.0}
    scale = kd.scale * mag
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
        t_load = t_scan = t_pair = t_mesh = 0.0
        meshes = {}
        if mesh_downsampling is not None and generate_sv_meshes:
            meshes["sv"] = find_meshes(cell, off, scale,
                                       downsampling=mesh_downsampling.get("sv", (1, 1, 1)))
            t_mesh += time.perf_counter() - t2
        for co in organelles:
            ta = time.perf_counter()
            sc = kd_orgs[co].load_seg(offset=off, size=size, mag=mag)
            tb = time.perf_counter()
            res["sc"][co] = object_properties_arrays(sc)
            tc = time.perf_counter()
            res["pairs"][co] = pair_counts(sc, cell)
            td = time.perf_counter()
            if mesh_downsampling is not None:
                meshes[co] = find_meshes(sc, off, scale,
                                         downsampling=mesh_downsampling.get(co, (1, 1, 1)))
                t_mesh += time.perf_counter() - td
            t_load += tb - ta
            t_scan += tc - tb
            t_pair += td - tc
        if mesh_downsampling is not None:
            res["meshes"] = meshes
        with stage_lock:
            stage["load_seconds"] += t1 - t0 + t_load
            stage["cell_scan_seconds"] += t2 - t1
            stage["organelle_scan_seconds"] += t_scan
            stage["pair_seconds"] += t_pair
            stage["mesh_seconds"] += t_mesh
        return res

    if cache_root is None:
        cache_root = os.path.dirname(os.path.abspath(os.path.normpath(kd_seg_path)))
    step = "sd_props" if mesh_downsampling is None else (
        "sd_props_mesh_sv" if generate_sv_meshes else "sd_props_mesh")
    cache = StepCache(step, cache_root, overwrite=overwrite)
    key = lambda c: f"{c[0]}_{c[1]}_{c[2]}"  # noqa: E731
    n_resumed = sum(1 for c in chunk_ixs if cache.done(key(c)))
    chunk_results = cached_map(work_chunk, chunk_ixs, cache, key_fn=key, n_workers=n_workers)

    merged = {}
    mesh_frags: Dict[str, Dict[int, list]] = {t: defaultdict(list) for t in ["sv"] + organelles}
    for t in ["sv"] + organelles:
        parts = [r["sv"] if t == "sv" else r["sc"][t] for r in chunk_results]
        # chunk-local coordinates -> the global frame before the merge
        merged[t] = _merge_with_offsets(parts, [r["off"] for r in chunk_results])
        for r in chunk_results:
            for oid, m in r.get("meshes", {}).get(t, {}).items():
                mesh_frags[t][oid].append(m)
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
    out = {"tables": tables, "mapping": {co: dict(m) for co, m in mapping.items()},
           "sc_sizes": sc_sizes, "counts": counts, "stats": stats}
    if mesh_downsampling is not None:
        out["meshes"] = {t: dict(f) for t, f in mesh_frags.items()}
    return out


def _merge_with_offsets(parts, offsets):
    shifted = []
    for (ids, rep, bb, sz), off in zip(parts, offsets):
        off = np.asarray(off, np.int64)
        shifted.append((ids, rep + off[None], bb + off[None, None], sz))
    return merge_prop_arrays(shifted)


def map_subcell_extract_props(
    kd_seg_path: str,
    kd_organelle_paths: Dict[str, str],
    n_folders_fs: int = 100,
    n_folders_fs_sc: int = 100,
    chunk_shape: Optional[Sequence[int]] = None,
    n_workers: Optional[int] = None,
    generate_sv_meshes: bool = True,
    mag: int = 1,
    mesh_downsampling: Optional[Dict[str, Sequence[int]]] = None,
    overwrite: bool = True,
    device=None,
) -> Dict:
    """Extract all SegmentationDatasets (sv + organelles) in one volume scan
    into the working directory of ``global_params.config``: the scan of
    :func:`map_subcell_extract_props_tables` with meshes, then
    :func:`_write_type` per type. ``chunk_shape``, ``mesh_downsampling`` and
    ``min_obj_vx`` default to the config's values; the resume cache lives
    under ``<wd>/.stepcache``. ``device``: None means the CUDA card
    (required), ``"cpu"`` runs the device scan's ops on the CPU.

    Returns type -> objects written, and ``"stats"``: the scan's statistics
    with ``write_seconds`` (the write phase's wall).
    """
    cfg = global_params.config
    if cfg.working_dir is None:
        raise ValueError("no working directory: set global_params.wd first")
    if chunk_shape is None:
        chunk_shape = cfg["tpu"]["chunk_shape"]
    if mesh_downsampling is None:
        mesh_downsampling = cfg["meshes"]["downsampling"]
    organelles = list(kd_organelle_paths.keys())
    res = map_subcell_extract_props_tables(
        kd_seg_path, kd_organelle_paths, chunk_shape=chunk_shape,
        min_obj_vx=cfg["cell_objects"]["min_obj_vx"], n_workers=n_workers, mag=mag,
        cache_root=cfg.working_dir, overwrite=overwrite, device=device,
        mesh_downsampling=mesh_downsampling, generate_sv_meshes=generate_sv_meshes)
    t0 = time.perf_counter()
    counts = {}
    for t in ["sv"] + organelles:
        ids, rep, bb, sz = res["tables"][t]
        nf = n_folders_fs if t == "sv" else n_folders_fs_sc
        sd = SegmentationDataset(t, working_dir=cfg.working_dir, n_folders_fs=nf, create=True)
        seg_path = kd_seg_path if t == "sv" else kd_organelle_paths[t]
        _write_type(sd, ids, rep, bb, sz, res["meshes"][t], res["mapping"].get(t),
                    res["mapping"] if t == "sv" else None, organelles, seg_path, n_workers,
                    res["sc_sizes"])
        counts[t] = len(ids)
    log.info("SD generation done: %s", counts)
    return {**counts, "stats": dict(res["stats"], write_seconds=time.perf_counter() - t0)}


def _write_type(
    sd: SegmentationDataset,
    ids, rep, bb, sz,
    mesh_frags: Dict[int, List],
    sc_mapping: Optional[Dict[int, Dict[int, int]]],
    sv_mappings: Optional[Dict[str, Dict[int, Dict[int, int]]]],
    organelles: List[str],
    voxeldata_path: str,
    n_workers,
    sc_sizes: Optional[Dict[str, Dict[int, int]]] = None,
):
    """Write per-shard stores + numpy caches for one object type."""
    id_set = set(int(i) for i in ids)
    # reverse aggregation for cell SVs: organelle objects mapped per SV
    sv_agg = None
    if sv_mappings is not None:
        sv_agg = {co: defaultdict(list) for co in organelles}
        for co in organelles:
            for sc_id, cell_counts in sv_mappings[co].items():
                for c_id, cnt in cell_counts.items():
                    if c_id in id_set:
                        sv_agg[co][c_id].append((sc_id, cnt))

    by_shard = defaultdict(list)
    for k, oid in enumerate(ids):
        by_shard[subfold_from_ix(int(oid), sd.n_folders_fs)].append(k)

    def write_shard(item):
        shard, ixs = item
        shard_dir = os.path.join(sd.so_storage_path, shard.strip("/"))
        os.makedirs(shard_dir, exist_ok=True)
        ad = AttributeDict(os.path.join(shard_dir, "attr_dict.pkl"), read_only=False,
                           disable_locking=True)
        ms = MeshStorage(os.path.join(shard_dir, "mesh.pkl"), read_only=False,
                         disable_locking=True)
        vd = VoxelStorageDyn(os.path.join(shard_dir, "voxel_dyn.pkl"), read_only=False,
                             disable_locking=True, voxeldata_path=voxeldata_path)
        for k in ixs:
            oid = int(ids[k])
            attrs = {
                "id": oid,
                "size": int(sz[k]),
                "rep_coord": rep[k].astype(np.int64),
                "bounding_box": bb[k].astype(np.int64),
            }
            if sc_mapping is not None:
                cc = sc_mapping.get(oid, {})
                m_ids = np.array(sorted(cc.keys()), np.uint64)
                m_ratios = np.array([cc[int(i)] for i in m_ids], np.float64) / max(int(sz[k]), 1)
                attrs["mapping_ids"] = m_ids
                attrs["mapping_ratios"] = m_ratios
            if sv_agg is not None:
                # per-SV reverse mapping; ratio = overlap / ORGANELLE size so
                # summing over a cell's SVs yields the fraction of the
                # organelle inside the cell (mapping-decision semantics)
                for co in organelles:
                    entries = sv_agg[co].get(oid, [])
                    entries.sort()
                    attrs[f"mapping_{co}_ids"] = np.array([e[0] for e in entries], np.uint64)
                    attrs[f"mapping_{co}_ratios"] = np.array(
                        [cnt / max(sc_sizes[co].get(int(sc_id), 1), 1) for sc_id, cnt in entries],
                        np.float64)
            ad[oid] = attrs
            frags = mesh_frags.get(oid, [])
            if frags:
                ms[oid] = merge_meshes(frags)
            vd.append_bounding_box(oid, bb[k])
            vd.increase_object_size(oid, int(sz[k]))
        ad.push()
        ms.push()
        vd.push()

    map_parallel(write_shard, list(by_shard.items()), n_workers=n_workers)

    sd.save_numpy_data("id", ids.astype(np.uint64))
    sd.save_numpy_data("size", sz.astype(np.int64))
    sd.save_numpy_data("rep_coord", rep.astype(np.int64))
    sd.save_numpy_data("bounding_box", bb.astype(np.int64))


def dataset_analysis(
    sd: SegmentationDataset,
    recompute: bool = False,
    compute_meshprops: bool = False,
    n_workers: Optional[int] = None,
):
    """Collect per-object attributes into ``{attr}s.npy`` dataset caches."""

    def collect(shard_dir):
        p = os.path.join(shard_dir, "attr_dict.pkl")
        if not os.path.isfile(p):
            return {}
        ad = AttributeDict(p, read_only=True, disable_locking=True)
        return {int(k): dict(v) for k, v in ad.items()}

    all_attrs: Dict[int, dict] = {}
    for d in map_parallel(collect, sd.so_dir_paths, n_workers=n_workers):
        all_attrs.update(d)
    if not all_attrs:
        sd.save_numpy_data("id", np.zeros(0, np.uint64))
        sd.save_numpy_data("size", np.zeros(0, np.int64))
        sd.save_numpy_data("rep_coord", np.zeros((0, 3), np.int64))
        sd.save_numpy_data("bounding_box", np.zeros((0, 2, 3), np.int64))
        return
    ids = np.array(sorted(all_attrs.keys()), np.uint64)
    # union of keys; missing values become None (object arrays)
    keys = set()
    for a in all_attrs.values():
        keys.update(a.keys())
    keys.discard("id")
    sd.save_numpy_data("id", ids)
    for key in keys:
        vals = [all_attrs[int(i)].get(key) for i in ids]
        try:
            arr = np.array(vals)
            if arr.dtype == object:
                raise ValueError
        except ValueError:
            arr = np.empty(len(vals), dtype=object)
            arr[:] = vals
        sd.save_numpy_data(key, arr)
    if compute_meshprops:
        areas = []
        for i in ids:
            so = sd.get_segmentation_object(int(i))
            areas.append(so.mesh_area)
        sd.save_numpy_data("mesh_area", np.array(areas, np.float64))


def sd_init(co: str, max_n_jobs: Optional[int] = None, log=None):
    """Mesh-cache initialization hook. Meshes are generated during the
    fused scan here, so this only validates that the dataset exists."""
    sd = SegmentationDataset(co, working_dir=global_params.config.working_dir)
    return sd.exists()
