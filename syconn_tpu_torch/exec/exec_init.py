"""Dataset initialisation — the device half of pipeline step 2, SD
generation (counterpart of ``syconn_tpu/exec/exec_init.py``).

:func:`kd_init` extracts one organelle type's instance segmentation from
its probability map; :func:`init_cell_subcell_tables` runs it for every
organelle of ``process_cell_organelles`` and then the fused property scan,
returning the tables that the JAX package's write phase (``_write_type``:
``SegmentationDataset`` stores, meshes, ``dataset_analysis``) receives.
That write phase and ``run_create_rag`` are not ported yet, nor the YAML
configuration: paths are explicit arguments and the organelle settings are
the dict :data:`CELL_OBJECTS` below.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

from ..extraction.object_extraction import from_probabilities_to_kd
from ..io.chunked import ChunkedVolume
from ..proc.sd_proc import map_subcell_extract_props_tables
from ..utils.stepcache import StepCache

log = logging.getLogger("syconn_tpu_torch.exec_init")

__all__ = ["CELL_OBJECTS", "PROCESS_CELL_ORGANELLES", "kd_init", "init_cell_subcell_tables"]

# syconn_tpu/handler/default_config.yml:15 and :82-128 (cell_objects)
PROCESS_CELL_ORGANELLES = ("mi", "vc")
CELL_OBJECTS = {
    "min_obj_vx": {"mi": 500, "sj": 100, "vc": 100, "er": 100, "golgi": 100, "sv": 1,
                   "cs": 10, "syn": 10, "syn_ssv": 100},
    "probathresholds": {"mi": 0.428571429, "sj": 0.19047619, "vc": 0.285714286, "er": 0.5,
                        "golgi": 0.5},
    "min_seed_vx": {"mi": 50, "sj": 10, "vc": 10, "er": 30, "golgi": 30},
    "extract_morph_op": {
        "mi": ["binary_opening", "binary_closing", "binary_erosion", "binary_erosion",
               "binary_erosion", "binary_erosion"],
        "sj": ["binary_opening", "binary_closing", "binary_erosion"],
        "vc": ["binary_opening", "binary_closing", "binary_erosion"],
        "er": ["binary_dilation", "binary_dilation", "binary_dilation", "binary_erosion",
               "binary_erosion", "binary_erosion"],
        "golgi": ["binary_dilation", "binary_dilation", "binary_dilation", "binary_erosion",
                  "binary_erosion", "binary_erosion"],
    },
}
# syconn_tpu/handler/default_config.yml:34 (tpu.chunk_shape)
CHUNK_SHAPE = (256, 256, 128)


def kd_init(co: str, prob_path: str, target_path: str,
            chunk_size: Optional[Sequence[int]] = None, cache_root: Optional[str] = None,
            overwrite: bool = True, device=None, **kw) -> Dict:
    """Instance segmentation of organelle type ``co`` from the probability
    map at ``prob_path`` into ``target_path`` (the JAX package's ``kd_init``
    -> ``generate_subcell_kd_from_proba``), with the threshold
    (``probathresholds`` x 255), morphology chain and seed size of
    :data:`CELL_OBJECTS`. Further keywords (``use_device``, ``n_workers``,
    ``sigma`` …) go to :func:`from_probabilities_to_kd`, whose statistics
    are returned."""
    return from_probabilities_to_kd(
        prob_path, target_path,
        thresh_uint8=float(CELL_OBJECTS["probathresholds"][co]) * 255.0,
        morph_ops=CELL_OBJECTS["extract_morph_op"].get(co, []),
        min_seed_vx=int(CELL_OBJECTS["min_seed_vx"].get(co, 1)),
        chunk_shape=CHUNK_SHAPE if chunk_size is None else chunk_size,
        cache_root=cache_root, overwrite=overwrite, device=device, **kw)


def init_cell_subcell_tables(kd_seg_path: str, prob_paths: Dict[str, str],
                             seg_paths: Dict[str, str],
                             chunk_size: Optional[Sequence[int]] = None,
                             cache_root: Optional[str] = None, overwrite: bool = False,
                             device=None) -> Dict:
    """Organelle extraction for ``PROCESS_CELL_ORGANELLES`` and the fused
    cell/organelle property scan: the device part of the JAX package's
    ``init_cell_subcell_sds`` (organelle extraction, then
    ``map_subcell_extract_props`` up to its write phase).

    ``prob_paths``/``seg_paths``: organelle -> probability map / target
    segmentation. A target that exists and whose step cache is complete is
    kept unless ``overwrite``; an incomplete one resumes per chunk.
    ``cache_root``: the step caches (default: each target's parent).

    Returns :func:`..proc.sd_proc.map_subcell_extract_props_tables`' result
    with ``"extraction"``: organelle -> the stats of :func:`kd_init` (None
    where the segmentation was kept)."""
    extraction = {}
    for co in PROCESS_CELL_ORGANELLES:
        target = seg_paths[co]
        root = cache_root or os.path.dirname(os.path.abspath(os.path.normpath(target)))
        name = os.path.basename(os.path.normpath(target))
        done = StepCache(f"objext_{name}_relabel", root).is_complete()
        if ChunkedVolume.exists(target) and done and not overwrite:
            log.info("organelle seg %s exists and is complete, skipping", co)
            extraction[co] = None
            continue
        extraction[co] = kd_init(co, prob_paths[co], target, chunk_size=chunk_size,
                                 cache_root=root, overwrite=overwrite, device=device)
        log.info("extracted %s: %s", co, extraction[co])
    res = map_subcell_extract_props_tables(
        kd_seg_path, {co: seg_paths[co] for co in PROCESS_CELL_ORGANELLES},
        chunk_shape=CHUNK_SHAPE if chunk_size is None else chunk_size,
        min_obj_vx=CELL_OBJECTS["min_obj_vx"], cache_root=cache_root, overwrite=overwrite,
        device=device)
    res["extraction"] = extraction
    return res
