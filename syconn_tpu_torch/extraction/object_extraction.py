"""Probability map -> instance segmentation, chunked with global stitching
(counterpart of ``syconn_tpu/extraction/object_extraction.py``).

Per organelle type:
  1. per chunk (+ halo covering the blur and morphology support): threshold
     the probability map, optional Gaussian blur, the configured morphology
     chain; trailing erosions make seeds for a watershed (seeds = connected
     components of the eroded mask, small seeds dropped);
  2. chunk-local connected components, encoded into a global uint64 label
     space by chunk index and written to the target volume;
  3. faces of adjacent chunks are compared; touching nonzero label pairs
     feed a union-find whose merge map compacts labels to 1..K;
  4. every chunk is read back, relabelled and written again.

Three routes for step 1: a probability map held by ``io.resident`` is
sliced on the device (:class:`..ops.morphology_torch.ResidentSegmenter`);
else chunk windows stream from disk through the device chain
(``use_device=True``, :func:`..ops.morphology_torch.segment_chunk_device`)
or through scipy on the host (``use_device=False``). Connected components
run on the device with the device chain and in scipy on the host route;
the watershed runs on the host. All routes give the same segmentation.

:func:`generate_subcell_kd_from_proba` takes the paths, threshold,
morphology chain and seed size of one organelle type from the working
directory's configuration, as the JAX package does.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import global_params
from ..io import resident
from ..io.chunked import ChunkedVolume
from ..ops.cc import (connected_components, encode_chunk_labels, face_merge_pairs,
                      merge_pairs_to_map, watershed_from_seeds)
from ..ops.contacts import relabel_vol_nonexist2zero
from ..ops.morphology import (apply_morphological_operations, gaussian_blur, get_aniso_struct,
                              morphology_halo)
from ..ops.morphology_torch import ResidentSegmenter, _split_ops, segment_chunk_device
from ..utils.device import default_device
from ..utils.stepcache import StepCache, cached_map

log = logging.getLogger("syconn_tpu_torch.extraction")

__all__ = ["from_probabilities_to_kd", "generate_subcell_kd_from_proba",
           "object_segmentation_chunk", "labels_from_masks"]


def _cdiv(a, b):
    return -(-a // b)


def _segment_masks(prob: np.ndarray, thresh_uint8: float, morph_ops: Sequence[str],
                   struct: Optional[np.ndarray], sigma: float, use_device: bool,
                   device) -> Tuple[np.ndarray, np.ndarray, int]:
    """(mask, eroded seed mask, n_trailing_ero) of one chunk window."""
    pre_ops, n_tr = _split_ops(morph_ops)
    if use_device and struct is not None:
        return segment_chunk_device(prob, float(thresh_uint8), morph_ops, struct, sigma=sigma,
                                    device=device)
    data = prob.astype(np.float32)
    if sigma and sigma > 0:
        data = gaussian_blur(data, sigma)
    mask = apply_morphological_operations(data >= float(thresh_uint8), pre_ops, struct=struct)
    eroded = (apply_morphological_operations(mask, ["binary_erosion"] * n_tr, struct=struct)
              if n_tr > 0 else mask)
    return mask, eroded, n_tr


def object_segmentation_chunk(prob: np.ndarray, thresh_uint8: float, morph_ops: Sequence[str],
                              struct: Optional[np.ndarray], min_seed_vx: int, sigma: float = 0.0,
                              use_device: bool = True, device=None) -> np.ndarray:
    """Instance labels (uint32, chunk-local components) of one chunk + halo
    of a uint8 probability map. ``use_device``: blur, threshold, morphology
    and connected components on ``device`` (None: the CUDA card, which must
    exist; ``"cpu"``: the same ops on the CPU); False runs scipy on the
    host. The watershed runs on the host either way."""
    if use_device:
        device = default_device(device)
    mask, eroded, n_tr = _segment_masks(prob, thresh_uint8, morph_ops, struct, sigma,
                                        use_device, device)
    return labels_from_masks(mask, eroded, n_tr, min_seed_vx,
                             device=device if use_device else False)


def labels_from_masks(mask: np.ndarray, eroded: np.ndarray, n_trailing_ero: int,
                      min_seed_vx: int, device=False) -> np.ndarray:
    """Host labeling half of the chunk worker: connected components of the
    filtered mask, or, when the chain ends in erosions, a seeded watershed
    from the eroded mask's components (seeds under ``min_seed_vx`` voxels
    dropped). ``device`` goes to :func:`..ops.cc.connected_components`."""
    if n_trailing_ero > 0:
        seeds, n = connected_components(eroded, device=device)
        if n > 0 and min_seed_vx > 1:
            ids, counts = np.unique(seeds[seeds != 0], return_counts=True)
            small = ids[counts < min_seed_vx]
            if len(small):
                seeds[np.isin(seeds, small)] = 0
        return watershed_from_seeds(mask, seeds)
    labels, _ = connected_components(mask, device=device)
    return labels


def from_probabilities_to_kd(
    src_kd_path: str,
    target_kd_path: str,
    thresh_uint8: float,
    morph_ops: Sequence[str],
    min_seed_vx: int = 1,
    chunk_shape: Sequence[int] = (256, 256, 256),
    sigma: float = 0.0,
    n_workers: Optional[int] = None,
    mag: int = 1,
    overwrite: bool = True,
    cache_root: Optional[str] = None,
    use_device: bool = True,
    device=None,
) -> Dict:
    """Chunked extraction of one type from the 'raw' channel of
    ``src_kd_path`` into the 'seg' channel of ``target_kd_path``.

    ``cache_root`` holds the step cache (default: the target's parent
    directory). With ``overwrite=False`` a crashed run resumes per chunk:
    chunk results and relabel markers persist in the step cache, completed
    chunks are skipped, and the final volume equals an uninterrupted run's.
    ``use_device``/``device``: see :func:`object_segmentation_chunk`; the
    entry point needs the card unless ``device="cpu"``, on every route.

    Returns ``n_objects``, ``n_chunks``, ``halo``, the ``route`` taken
    (``"resident"``, ``"device"`` or ``"host"``) and seconds: ``seconds``
    (the call), ``segment_seconds``, ``stitch_seconds`` and
    ``relabel_seconds`` (wall of steps 1-2, 3 and 4), and the thread-seconds
    of step 1-2's stages: ``load_seconds`` (disk reads), ``chain_seconds``
    (blur, threshold, morphology, readback), ``label_seconds`` (connected
    components and watershed), ``write_seconds`` (encode, faces, write).
    """
    device = default_device(device)
    t_start = time.perf_counter()
    step_name = os.path.basename(os.path.normpath(target_kd_path))
    if cache_root is None:
        cache_root = os.path.dirname(os.path.abspath(os.path.normpath(target_kd_path)))
    seg_cache = StepCache(f"objext_{step_name}_segment", cache_root, overwrite=overwrite)
    relabel_cache = StepCache(f"objext_{step_name}_relabel", cache_root, overwrite=overwrite)
    src = ChunkedVolume.open(src_kd_path)
    sh = src.mag_shape(mag)
    cs = np.minimum(np.asarray(chunk_shape, np.int64), sh)
    grid = _cdiv(sh, cs)
    n_chunks = int(np.prod(grid))
    scale = src.scale * mag
    struct = get_aniso_struct(scale)
    halo = morphology_halo(morph_ops, sigma=sigma, struct_extent=int(np.max(struct.shape) // 2))
    target = ChunkedVolume.create(target_kd_path, scale=scale, boundary=sh,
                                  experiment_name=src.experiment_name,
                                  chunk_shape=tuple(int(c) for c in cs))
    chunk_ixs = [(cx, cy, cz) for cx in range(grid[0]) for cy in range(grid[1])
                 for cz in range(grid[2])]
    stage = {"load_seconds": 0.0, "chain_seconds": 0.0, "label_seconds": 0.0,
             "write_seconds": 0.0}
    stage_lock = threading.Lock()

    def lin(cix):
        return (cix[0] * grid[1] + cix[1]) * grid[2] + cix[2]

    def _ckey(cix):
        return f"{cix[0]}_{cix[1]}_{cix[2]}"

    def finish_chunk(cix, lab, size):
        """Label volume (chunk + halo) -> encode, write, face capture."""
        core = lab[halo:halo + size[0], halo:halo + size[1], halo:halo + size[2]]
        enc = encode_chunk_labels(core, lin(cix))
        target.save_seg(enc, offset=np.array(cix) * cs, mags=(mag,), data_mag=mag)
        ids = np.unique(enc)
        face_list = []
        for a in range(3):
            sl_first = [slice(None)] * 3
            sl_last = [slice(None)] * 3
            sl_first[a] = 0
            sl_last[a] = -1
            face_list.append((enc[tuple(sl_first)].copy(), enc[tuple(sl_last)].copy()))
        return cix, ids[ids != 0], face_list

    # a probability map held in device memory: windows are sliced on the
    # device and only 2-bit packed masks are read back
    res_segmenter = None
    res_prob = resident.get(src_kd_path, "raw", mag) if mag == 1 else None
    if res_prob is not None:
        res_segmenter = ResidentSegmenter(res_prob, tuple(int(c) for c in cs), int(halo),
                                          thresh_uint8, morph_ops, struct, sigma=sigma)
    route = "resident" if res_segmenter is not None else ("device" if use_device else "host")
    cc_device = device if use_device else False

    def work_segment(cix):
        off = np.array(cix) * cs
        size = np.minimum(cs, sh - off)
        t0 = time.perf_counter()
        if res_segmenter is not None:
            t1 = t0
            mask, eroded, n_tr = res_segmenter.fetch(res_segmenter.dispatch(cix))
        else:
            prob = src.load_raw(offset=off - halo, size=size + 2 * halo, mag=mag)
            t1 = time.perf_counter()
            mask, eroded, n_tr = _segment_masks(prob, thresh_uint8, morph_ops, struct, sigma,
                                                use_device, device)
        t2 = time.perf_counter()
        lab = labels_from_masks(mask, eroded, n_tr, min_seed_vx, device=cc_device)
        t3 = time.perf_counter()
        res = finish_chunk(cix, lab, size)
        t4 = time.perf_counter()
        with stage_lock:
            stage["load_seconds"] += t1 - t0
            stage["chain_seconds"] += t2 - t1
            stage["label_seconds"] += t3 - t2
            stage["write_seconds"] += t4 - t3
        return res

    n_resumed = sum(1 for c in chunk_ixs if seg_cache.done(_ckey(c)))
    faces: Dict[Tuple[int, int, int], List] = {}
    uniq_ids: List[np.ndarray] = []
    t_seg = time.perf_counter()
    for cix, ids, face_list in cached_map(work_segment, chunk_ixs, seg_cache, key_fn=_ckey,
                                          n_workers=n_workers):
        uniq_ids.append(ids)
        faces[cix] = face_list
    t_stitch = time.perf_counter()

    # step 3: face comparison -> union find -> compact merge map
    pairs = []
    for cix, face_list in faces.items():
        for a in range(3):
            ncix = list(cix)
            ncix[a] += 1
            ncix = tuple(ncix)
            if ncix in faces:
                pairs.append(face_merge_pairs(face_list[a][1], faces[ncix][a][0]))
    all_labels = np.concatenate(uniq_ids) if uniq_ids else np.zeros(0, np.uint64)
    pair_arr = np.concatenate(pairs) if pairs else np.zeros((0, 2), np.uint64)
    merge_map = merge_pairs_to_map(all_labels, pair_arr, compact=True)
    n_objects = len(set(merge_map.values()))
    t_relabel = time.perf_counter()

    # step 4: read back, relabel, rewrite. The relabel is not idempotent
    # (compact labels are unknown to merge_map), so per-chunk markers gate
    # it: a resumed run must not relabel twice.
    def work_write(cix):
        off = np.array(cix) * cs
        size = np.minimum(cs, sh - off)
        enc = target.load_seg(offset=off, size=size, mag=mag)
        target.save_seg(relabel_vol_nonexist2zero(enc, merge_map), offset=off, mags=(mag,),
                        data_mag=mag)
        return True

    cached_map(work_write, chunk_ixs, relabel_cache, key_fn=_ckey, n_workers=n_workers)
    seg_cache.mark_complete()
    relabel_cache.mark_complete()
    t_end = time.perf_counter()
    log.info("object extraction %s (%s): %d chunks, %d objects", target_kd_path, route,
             n_chunks, n_objects)
    return {"n_objects": n_objects, "n_chunks": n_chunks, "halo": halo, "route": route,
            "resumed": n_resumed, "seconds": t_end - t_start,
            "segment_seconds": t_stitch - t_seg, "stitch_seconds": t_relabel - t_stitch,
            "relabel_seconds": t_end - t_relabel, **stage}


def generate_subcell_kd_from_proba(
    co: str,
    chunk_size: Optional[Sequence[int]] = None,
    n_workers: Optional[int] = None,
    proba_path: Optional[str] = None,
    target_path: Optional[str] = None,
    **kw,
) -> Dict:
    """Instance segmentation of organelle type ``co`` with the settings of
    ``global_params.config``: probability map ``kd_organelle_proba_paths``,
    target ``kd_organelle_seg_paths``, threshold ``probathresholds`` x 255,
    the ``extract_morph_op`` chain, ``min_seed_vx`` and chunk
    ``tpu.chunk_shape``. ``proba_path``/``target_path`` override the
    configured paths; without them the step cache lives under
    ``<wd>/.stepcache`` (with them, see :func:`from_probabilities_to_kd`).
    Further keywords (``device``, ``use_device``, ``overwrite``,
    ``cache_root`` …) go to :func:`from_probabilities_to_kd`, whose
    statistics are returned."""
    cfg = global_params.config
    if chunk_size is None:
        chunk_size = cfg["tpu"]["chunk_shape"]
    if proba_path is None or target_path is None:
        if cfg.working_dir is None:
            raise ValueError("no working directory: set global_params.wd or pass "
                             "proba_path and target_path")
        kw.setdefault("cache_root", cfg.working_dir)
    proba_path = proba_path or cfg.kd_organelle_proba_paths[co]
    target_path = target_path or cfg.kd_organelle_seg_paths[co]
    cell_objects = cfg["cell_objects"]
    return from_probabilities_to_kd(
        proba_path, target_path,
        thresh_uint8=float(cell_objects["probathresholds"][co]) * 255.0,
        morph_ops=cell_objects["extract_morph_op"].get(co, []),
        min_seed_vx=int(cell_objects["min_seed_vx"].get(co, 1)),
        chunk_shape=chunk_size, n_workers=n_workers, **kw)
