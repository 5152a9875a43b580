"""Contact-site and synapse-fragment extraction — pipeline step 6a
(counterpart of ``syconn_tpu/extraction/cs_extraction.py``).

Per chunk (+ stencil halo): boundary detection and the window-majority
partner vote yield the contact-site segmentation (labels = packed sorted
supervoxel-ID pairs). Each contact site is closed and dilated into
background only, intersected with the synapse-junction foreground to get
'syn' fragments, and symmetric/asymmetric type counts are accumulated. The
reduce phase merges the per-chunk properties into per-object tables.

:func:`extract_contact_sites` takes its paths and settings from the working
directory's configuration, as in the JAX package, and writes the 'cs' and
'syn' ``SegmentationDataset``s (:func:`_write_partner_sd`) and the label
volumes ``knossosdatasets/{cs_seg,syn_seg}``. Its detection and reduce step
is :func:`extract_contact_site_tables`, which takes explicit arguments and
returns the merged tables.
"""

from __future__ import annotations

import logging
import os
import time
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import global_params
from ..backend import AttributeDict, VoxelStorageLazyLoading
from ..io import resident
from ..io.chunked import ChunkedVolume
from ..ops.contacts import cs_pair_unpack, detect_cs, extract_cs_syntype
from ..ops.morphology import get_aniso_struct, multi_mop_backgroundonly
from ..parallel.executor import map_parallel
from ..reps.rep_helper import subfold_from_ix
from ..reps.segmentation import SegmentationDataset
from ..utils.device import default_device
from ..utils.stepcache import StepCache

log = logging.getLogger("syconn_tpu_torch.cs_extraction")

__all__ = ["extract_contact_sites", "extract_contact_site_tables"]


def _cdiv(a, b):
    return -(-a // b)


def extract_contact_sites(
    chunk_shape: Optional[Sequence[int]] = None,
    n_workers: Optional[int] = None,
    mag: int = 1,
    n_folders_fs: int = 100,
    mesh=None,
    overwrite: bool = True,
    kernel: str = "auto",
    device=None,
) -> Dict:
    """Extract the 'cs' and 'syn' SegmentationDatasets and label volumes of
    the working directory of ``global_params.config``: the segmentation
    ``kd_seg_path``, the synapse-junction map ``kd_sj_path`` and, where
    ``syntype_avail``, the type maps ``kd_sym_path``/``kd_asym_path`` (each
    used only where it exists), with ``cs_filtersize``, ``cs_dilation``, the
    sj probability threshold and ``min_obj_vx`` of ``cell_objects``; chunk
    ``tpu.chunk_shape`` by default. The resume cache lives under
    ``<wd>/.stepcache``. ``mesh`` (a multi-device slab path in the JAX
    package) is not ported. ``kernel``/``device``: see
    :func:`extract_contact_site_tables`.

    Returns ``{"n_cs", "n_syn"}``, the objects written, and ``"stats"``: the
    detection's statistics with ``write_seconds``.
    """
    if mesh is not None:
        raise NotImplementedError("the sharded slab path needs multi-device support, which is "
                                  "not ported yet (ROADMAP Queue 1, multi-device)")
    cfg = global_params.config
    if cfg.working_dir is None:
        raise ValueError("no working directory: set global_params.wd first")
    co = cfg["cell_objects"]
    out_dir = os.path.join(str(cfg.working_dir), "knossosdatasets")
    sym = asym = None
    if bool(cfg["syntype_avail"]) and os.path.isdir(cfg.kd_sym_path) \
            and os.path.isdir(cfg.kd_asym_path):
        sym, asym = cfg.kd_sym_path, cfg.kd_asym_path
    res = extract_contact_site_tables(
        cfg.kd_seg_path, out_dir,
        kd_sj_path=cfg.kd_sj_path if os.path.isdir(cfg.kd_sj_path) else None,
        kd_sym_path=sym, kd_asym_path=asym,
        chunk_shape=cfg["tpu"]["chunk_shape"] if chunk_shape is None else chunk_shape,
        stencil=co["cs_filtersize"], cs_dilation=int(co["cs_dilation"]),
        sj_thresh=float(co["probathresholds"]["sj"]),
        min_obj_vx={"cs": int(co["min_obj_vx"].get("cs", 1)),
                    "syn": int(co["min_obj_vx"].get("syn", 1))},
        mag=mag, n_workers=n_workers, overwrite=overwrite, kernel=kernel, device=device,
        cache_root=str(cfg.working_dir))
    t0 = time.perf_counter()
    _write_partner_sd("cs", res["cs"], n_folders_fs, os.path.join(out_dir, "cs_seg"), n_workers)
    _write_partner_sd("syn", res["syn"], n_folders_fs, os.path.join(out_dir, "syn_seg"),
                      n_workers)
    log.info("extract_contact_sites: %d cs, %d syn fragments", res["n_cs"], res["n_syn"])
    return {"n_cs": res["n_cs"], "n_syn": res["n_syn"],
            "stats": dict(res["stats"], write_seconds=time.perf_counter() - t0)}


def _write_partner_sd(obj_type: str, table: Dict, n_folders_fs: int, voxeldata_path: str,
                      n_workers):
    """Write one table of :func:`extract_contact_site_tables` as the
    ``obj_type`` dataset: per-shard attribute dicts (id, size, rep_coord,
    bounding_box, partner_ids; syn also asym_prop, sym_prop, cs_id) and, for
    syn, the voxel coordinates (``voxel_lazy.npz``); then the numpy caches."""
    cfg = global_params.config
    sd = SegmentationDataset(obj_type, working_dir=cfg.working_dir, n_folders_fs=n_folders_fs,
                             create=True)
    ids = table["ids"]
    row = {int(oid): k for k, oid in enumerate(ids)}
    by_shard = defaultdict(list)
    for oid in ids:
        by_shard[subfold_from_ix(int(oid), n_folders_fs)].append(int(oid))

    def write_shard(item):
        shard, oids = item
        shard_dir = os.path.join(sd.so_storage_path, shard.strip("/"))
        os.makedirs(shard_dir, exist_ok=True)
        ad = AttributeDict(os.path.join(shard_dir, "attr_dict.pkl"), read_only=False,
                           disable_locking=True)
        vl = (VoxelStorageLazyLoading(os.path.join(shard_dir, "voxel_lazy.npz"))
              if obj_type == "syn" else None)
        for oid in oids:
            k = row[oid]
            attrs = {
                "id": oid,
                "size": int(table["sizes"][k]),
                "rep_coord": np.asarray(table["rep_coords"][k], np.int64),
                "bounding_box": np.asarray(table["bounding_boxes"][k], np.int64),
                "partner_ids": np.asarray(table["partner_ids"][k], np.uint64),
            }
            if obj_type == "syn":
                attrs["asym_prop"] = float(table["asym_prop"][k])
                attrs["sym_prop"] = float(table["sym_prop"][k])
                attrs["cs_id"] = oid
                vl[oid] = table["voxels"][k]
            ad[oid] = attrs
        ad.push()
        if vl is not None:
            vl.push()

    map_parallel(write_shard, list(by_shard.items()), n_workers=n_workers)
    sd.save_numpy_data("id", ids)
    sd.save_numpy_data("size", table["sizes"])
    sd.save_numpy_data("rep_coord", table["rep_coords"])
    sd.save_numpy_data("bounding_box", table["bounding_boxes"])
    if obj_type == "syn":
        sd.save_numpy_data("asym_prop", table["asym_prop"])
        sd.save_numpy_data("sym_prop", table["sym_prop"])


def extract_contact_site_tables(
    kd_seg_path: str,
    out_dir: str,
    kd_sj_path: Optional[str] = None,
    kd_sym_path: Optional[str] = None,
    kd_asym_path: Optional[str] = None,
    chunk_shape: Sequence[int] = (256, 256, 128),
    stencil: Sequence[int] = (13, 13, 7),
    cs_dilation: int = 2,
    sj_thresh: float = 0.19047619,
    scale: Optional[Sequence[float]] = None,
    min_obj_vx: Optional[Dict[str, int]] = None,
    mag: int = 1,
    n_workers: Optional[int] = None,
    overwrite: bool = True,
    kernel: str = "auto",
    device=None,
    cache_root: Optional[str] = None,
) -> Dict:
    """Extract contact sites and synapse fragments of a segmentation.

    Args:
        kd_seg_path: chunked volume holding the supervoxel segmentation.
        out_dir: receives the label volumes ``cs_seg`` and ``syn_seg`` and
            the per-chunk resume cache.
        kd_sj_path: synapse-junction probability map (uint8); without it no
            voxel is synaptic. kd_sym_path/kd_asym_path: synapse-type maps;
            both or neither.
        chunk_shape, stencil, cs_dilation, sj_thresh (a probability),
        min_obj_vx (``{"cs": n, "syn": n}``): the defaults are the JAX
            package's ``handler/default_config.yml``.
        scale: voxel size for the anisotropic structuring element; default
            the segmentation volume's scale times ``mag``.
        overwrite: False resumes a crashed run per chunk: a chunk's
            properties persist in the step cache after its label chunks are
            written.
        kernel: ``"auto"``, ``"cuda"`` or ``"torch"`` choose the device
            formulation (see ``ops.contacts_torch.CsDispatcher``); ``"host"``
            runs the exact host kernel on every chunk.
        device: ``None`` means the CUDA card (required); ``"cpu"`` runs the
            plain versions.
        cache_root: holds the resume cache (default ``out_dir``).

    Three detection paths: a segmentation held by ``io.resident`` is sliced
    in device memory and read back sparsely; else chunks stream through the
    pipelined ``CsDispatcher`` (loader threads prefetch, two dispatches in
    flight, host threads post-process); chunks with ids of 2**31 and above
    take the host kernel, and ids of 2**32 and above raise.

    Returns ``{"n_cs", "n_syn", "cs": table, "syn": table, "stats"}``.
    ``stats`` names the path taken and counts chunks (dispatched, resumed,
    host-routed), columns and overflowing columns, and seconds: the whole
    call, the main thread's share in detection (dispatch to fetch, of which
    ``prep_seconds`` and ``finish_seconds`` are the host code around the
    device work) and the thread-seconds of post-processing. A
    table holds, for the objects with at least ``min_obj_vx`` voxels, sorted
    by id: ``ids``, ``sizes``, ``rep_coords`` (n, 3), ``bounding_boxes``
    (n, 2, 3), ``partner_ids`` (n, 2); the syn table also ``asym_prop``,
    ``sym_prop`` and ``voxels`` (one (N, 3) coordinate array per object).
    """
    device = default_device(device)
    if kernel not in ("auto", "cuda", "torch", "host"):
        raise ValueError(f"unknown cs kernel: {kernel!r}")
    if (kd_sym_path is None) != (kd_asym_path is None):
        raise ValueError("give both kd_sym_path and kd_asym_path, or neither")
    t_start = time.perf_counter()
    cache = StepCache("cs_extract", cache_root or out_dir, overwrite=overwrite)
    kd = ChunkedVolume.open(kd_seg_path)
    sh = kd.mag_shape(mag)
    cs = np.minimum(np.asarray(chunk_shape, np.int64), sh)
    grid = _cdiv(sh, cs)
    stencil = np.asarray(stencil, np.int32)
    stencil_t = tuple(int(s) for s in stencil)
    halo = stencil // 2
    scale = kd.scale * mag if scale is None else np.asarray(scale, np.float32)
    struct = get_aniso_struct(scale)
    n_dil = int(cs_dilation)
    sj_thresh_u8 = float(sj_thresh) * 255.0
    min_obj_vx = {"cs": 10, "syn": 10, **(min_obj_vx or {})}

    kd_sj = ChunkedVolume.open(kd_sj_path) if kd_sj_path is not None else None
    kd_sym = ChunkedVolume.open(kd_sym_path) if kd_sym_path is not None else None
    kd_asym = ChunkedVolume.open(kd_asym_path) if kd_asym_path is not None else None

    def create(name):
        return ChunkedVolume.create(os.path.join(out_dir, name), scale=scale, boundary=sh,
                                    chunk_shape=tuple(int(c) for c in cs))

    cs_kd, syn_kd = create("cs_seg"), create("syn_seg")
    chunk_ixs = [(cx, cy, cz) for cx in range(grid[0]) for cy in range(grid[1])
                 for cz in range(grid[2])]
    stats = {"path": None, "chunks": len(chunk_ixs), "resumed": 0, "dispatched": 0,
             "host_chunks": 0, "columns": 0, "overflow_columns": 0,
             "detect_seconds": 0.0, "prep_seconds": 0.0, "finish_seconds": 0.0,
             "post_seconds": 0.0}

    def _detect_host(seg):
        if seg.max() < 2**32:
            return detect_cs(seg.astype(np.uint32), stencil=stencil)
        # contact-site IDs are packed partner pairs (lo << 32 | hi): larger
        # IDs would silently corrupt every later cs_pair_unpack
        raise ValueError(
            f"supervoxel IDs up to {int(seg.max())} exceed the 32-bit packed contact-site "
            "codec (lo << 32 | hi); relabel the segmentation to IDs < 2**32 before contact "
            "extraction")

    def _post(cix, cs_seg):
        """Host post-processing after contact detection (threads)."""
        t0 = time.perf_counter()
        off = np.array(cix) * cs
        size = np.minimum(cs, sh - off)
        if not cs_seg.any():
            # no contact sites in this chunk: skip the sj/sym/asym loads and
            # the morphology; write the (trivial) label chunks
            cs_kd.save_seg(cs_seg, offset=off, mags=(mag,), data_mag=mag)
            syn_kd.save_seg(cs_seg, offset=off, mags=(mag,), data_mag=mag)
            return off, ({}, {}, {}), ({}, {}, {}), {}, {}, {}, time.perf_counter() - t0
        # close + dilate each contact site into background only
        n_close = int(np.max(stencil // 2))
        if n_close > 0:
            cs_seg = multi_mop_backgroundonly("binary_closing", cs_seg, iterations=n_close,
                                              struct=struct)
        if n_dil > 0:
            cs_seg = multi_mop_backgroundonly("binary_dilation", cs_seg, iterations=n_dil,
                                              struct=struct)
        # synapse-junction foreground + type maps
        if kd_sj is not None:
            sj_fg = (kd_sj.load_raw(offset=off, size=size, mag=mag) >= sj_thresh_u8).astype(np.uint8)
        else:
            sj_fg = np.zeros(tuple(size), np.uint8)
        if kd_sym is not None:
            sym = (kd_sym.load_raw(offset=off, size=size, mag=mag) >= 128).astype(np.uint8)
            asym = (kd_asym.load_raw(offset=off, size=size, mag=mag) >= 128).astype(np.uint8)
        else:
            sym = np.zeros(tuple(size), np.uint8)
            asym = np.zeros(tuple(size), np.uint8)
        cs_props, syn_props, cs_asym, cs_sym, voxels_syn = extract_cs_syntype(
            cs_seg, sj_fg, asym, sym, offset=off)
        cs_kd.save_seg(cs_seg, offset=off, mags=(mag,), data_mag=mag)
        syn_kd.save_seg(cs_seg * (sj_fg > 0), offset=off, mags=(mag,), data_mag=mag)
        return off, cs_props, syn_props, cs_asym, cs_sym, voxels_syn, time.perf_counter() - t0

    def _load(cix):
        off = np.array(cix) * cs
        size = np.minimum(cs, sh - off)
        return kd.load_seg(offset=off - halo, size=size + 2 * halo, mag=mag)

    def _ckey(cix):
        return f"{cix[0]}_{cix[1]}_{cix[2]}"

    def _post_cached(cix, cs_seg):
        r = _post(cix, cs_seg)
        cache.store(_ckey(cix), r)
        return r

    def _timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        stats["detect_seconds"] += time.perf_counter() - t0
        return out

    results = [cache.load(_ckey(c)) for c in chunk_ixs if cache.done(_ckey(c))]
    chunk_ixs = [c for c in chunk_ixs if not cache.done(_ckey(c))]
    stats["resumed"] = len(results)
    if results:
        log.info("resume: %d completed chunks loaded from the step cache", len(results))

    # the segmentation already lives in device memory: windows are sliced
    # there and contact voxels come back sparse — takes precedence over the
    # upload dispatcher
    res_seg = None
    if chunk_ixs and mag == 1 and kernel != "host":
        res_seg = resident.get(kd_seg_path, "seg", mag)
    poster = ThreadPoolExecutor(max_workers=n_workers or 8)
    post_futs = []
    inflight: deque = deque()
    try:
        if res_seg is not None:
            from ..ops.contacts_torch import ResidentCsDetector

            stats["path"] = "resident"
            det = ResidentCsDetector(res_seg, chunk=tuple(int(c) for c in cs), stencil=stencil_t)

            def _finish(handle):
                cix = handle[0]
                packed, ovf = _timed(det.fetch, handle)
                if ovf:
                    stats["host_chunks"] += 1
                    packed = _timed(_detect_host, _load(cix))
                post_futs.append(poster.submit(_post_cached, cix, packed))

            for cix in chunk_ixs:
                inflight.append(_timed(det.dispatch, cix))
                stats["dispatched"] += 1
                while len(inflight) > 2:
                    _finish(inflight.popleft())
            while inflight:
                _finish(inflight.popleft())
            results += [f.result() for f in post_futs]
        elif kernel == "host":
            stats["path"] = "host"
            stats["host_chunks"] = len(chunk_ixs)

            def work(cix):
                return _post_cached(cix, _detect_host(_load(cix)))

            results += map_parallel(work, chunk_ixs, n_workers=n_workers)
        elif chunk_ixs:
            # pipelined: loader threads prefetch; the device detects
            # (asynchronously, depth 2); host threads do closing, typing and
            # writes concurrently
            from ..ops.contacts_torch import CsDispatcher

            stats["path"] = "stream"
            dispatcher = CsDispatcher(stencil=stencil_t, kernel=kernel, device=device)
            loader = ThreadPoolExecutor(max_workers=min(8, len(chunk_ixs)))
            prefetch = 4
            load_futs = {i: loader.submit(_load, chunk_ixs[i])
                         for i in range(min(prefetch, len(chunk_ixs)))}

            def _drain():
                j, handle = inflight.popleft()
                post_futs.append(poster.submit(_post_cached, chunk_ixs[j],
                                               _timed(dispatcher.fetch, handle)))

            try:
                for i in range(len(chunk_ixs)):
                    seg = load_futs.pop(i).result()
                    nxt = i + prefetch
                    if nxt < len(chunk_ixs):
                        load_futs[nxt] = loader.submit(_load, chunk_ixs[nxt])
                    if seg.max() < 2**31:
                        inflight.append((i, _timed(dispatcher.dispatch, seg)))
                        stats["dispatched"] += 1
                    else:
                        stats["host_chunks"] += 1
                        post_futs.append(poster.submit(_post_cached, chunk_ixs[i],
                                                       _timed(_detect_host, seg)))
                    while len(inflight) > 2:
                        _drain()
                while inflight:
                    _drain()
                results += [f.result() for f in post_futs]
            finally:
                loader.shutdown()
            stats["columns"] = dispatcher.n_columns
            stats["overflow_columns"] = dispatcher.n_overflow
            stats["prep_seconds"] = dispatcher.prep_seconds
            stats["finish_seconds"] = dispatcher.finish_seconds
    finally:
        poster.shutdown()
    # chunk order, whatever order the chunks finished in or were resumed
    results.sort(key=lambda r: tuple(int(o) for o in r[0]))
    stats["post_seconds"] = float(sum(r[6] for r in results))

    # --------------------------------------------------------------- reduce
    def merge_props(which):
        rep: Dict[int, np.ndarray] = {}
        bb: Dict[int, np.ndarray] = {}
        sz: Dict[int, int] = defaultdict(int)
        for r in results:
            off = r[0]
            rd, bd, sd_ = r[which]
            for k in sd_:
                gbb = bd[k] + off[None]
                if k in bb:
                    bb[k] = np.array([np.minimum(bb[k][0], gbb[0]), np.maximum(bb[k][1], gbb[1])])
                else:
                    bb[k] = gbb
                    rep[k] = rd[k] + off
                sz[k] += sd_[k]
        return rep, bb, sz

    asym_tot: Dict[int, int] = defaultdict(int)
    sym_tot: Dict[int, int] = defaultdict(int)
    vox_tot: Dict[int, List[np.ndarray]] = defaultdict(list)
    for _, _, _, cs_a, cs_s, vx, _ in results:
        for k, v in cs_a.items():
            asym_tot[k] += v
        for k, v in cs_s.items():
            sym_tot[k] += v
        for k, coords in vx.items():
            vox_tot[k].append(coords)

    cs_table = _partner_table(*merge_props(1), int(min_obj_vx["cs"]))
    syn_table = _partner_table(*merge_props(2), int(min_obj_vx["syn"]), asym_tot, sym_tot, vox_tot)
    cache.mark_complete()
    stats["seconds"] = time.perf_counter() - t_start
    n_cs, n_syn = len(cs_table["ids"]), len(syn_table["ids"])
    log.info("contact-site tables: %d cs, %d syn fragments", n_cs, n_syn)
    return {"n_cs": n_cs, "n_syn": n_syn, "cs": cs_table, "syn": syn_table, "stats": stats}


def _partner_table(rep, bb, sz, min_vx: int, asym_tot=None, sym_tot=None, vox_tot=None) -> Dict:
    """Per-object arrays of the objects with at least ``min_vx`` voxels,
    sorted by id (what the JAX package writes into a ``SegmentationDataset``
    as numpy data and attributes)."""
    ids = np.array(sorted(k for k, v in sz.items() if v >= min_vx), np.uint64)
    lo, hi = cs_pair_unpack(ids)
    table = {
        "ids": ids,
        "sizes": np.array([sz[int(i)] for i in ids], np.int64),
        "rep_coords": np.array([rep[int(i)] for i in ids], np.int64).reshape(-1, 3),
        "bounding_boxes": np.array([bb[int(i)] for i in ids], np.int64).reshape(-1, 2, 3),
        "partner_ids": np.stack([lo, hi], axis=1).astype(np.uint64),
    }
    if asym_tot is not None:
        total = np.array([max(sz[int(i)], 1) for i in ids], np.float64)
        table["asym_prop"] = np.array([asym_tot.get(int(i), 0) for i in ids]) / total
        table["sym_prop"] = np.array([sym_tot.get(int(i), 0) for i in ids]) / total
        table["voxels"] = [np.concatenate(vox_tot[int(i)]) if vox_tot[int(i)]
                           else np.zeros((0, 3), np.int64) for i in ids]
    return table
