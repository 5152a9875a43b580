"""Dataset initialisation — pipeline step 2, SD generation (counterpart of
``syconn_tpu/exec/exec_init.py``).

:func:`init_cell_subcell_sds` extracts every organelle type of the working
directory's ``process_cell_organelles`` from its probability map
(:func:`kd_init`), runs the fused property, mapping and mesh scan and
writes the ``sv`` and organelle ``SegmentationDataset``s with their
``dataset_analysis`` caches; :func:`run_create_rag` prunes the initial
supervoxel graph by connected-component size; :func:`run_create_neuron_ssd`
(step 4) assembles cells from the neuron graph of step 3, or the pruned
graph where step 3 did not run, into the ``SuperSegmentationDataset``. They
take their paths and settings from ``global_params.config``.

:func:`init_cell_subcell_tables` is the same extraction and scan on
explicit paths, returning the tables instead of writing datasets.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

from .. import global_params
from ..extraction.object_extraction import generate_subcell_kd_from_proba
from ..handler.config import initialize_logging
from ..io.chunked import ChunkedVolume
from ..io.graph import load_svgraph, save_svgraph
from ..proc.graphs import create_ccsize_dict
from ..proc.sd_proc import dataset_analysis, map_subcell_extract_props, \
    map_subcell_extract_props_tables
from ..reps.segmentation import SegmentationDataset
from ..utils.device import default_device
from ..utils.stepcache import StepCache

log = logging.getLogger("syconn_tpu_torch.exec_init")

__all__ = ["kd_init", "sd_init", "init_cell_subcell_sds", "run_create_rag",
           "run_create_neuron_ssd", "init_cell_subcell_tables"]


def kd_init(co: str, chunk_size=None, **kw) -> Dict:
    """Extract organelle type ``co``'s instance segmentation from its
    probability map with the config's settings
    (:func:`..extraction.object_extraction.generate_subcell_kd_from_proba`,
    which takes ``proba_path``/``target_path`` overrides and passes
    ``device``, ``overwrite`` … on)."""
    return generate_subcell_kd_from_proba(co, chunk_size=chunk_size, **kw)


def sd_init(co: str, **kw):
    from ..proc.sd_proc import sd_init as _sd_init

    return _sd_init(co, **kw)


def _extract_organelles(prob_paths: Dict[str, str], seg_paths: Dict[str, str],
                        chunk_size, cache_root: Optional[str], overwrite: bool, device,
                        lg) -> Dict:
    """kd_init per organelle; a target that exists and whose step cache is
    complete is kept unless ``overwrite`` (an incomplete one resumes)."""
    extraction = {}
    for co, target in seg_paths.items():
        root = cache_root or os.path.dirname(os.path.abspath(os.path.normpath(target)))
        name = os.path.basename(os.path.normpath(target))
        done = StepCache(f"objext_{name}_relabel", root).is_complete()
        if ChunkedVolume.exists(target) and done and not overwrite:
            lg.info("organelle seg %s exists and is complete, skipping", co)
            extraction[co] = None
            continue
        extraction[co] = kd_init(co, chunk_size=chunk_size, proba_path=prob_paths[co],
                                 target_path=target, cache_root=root, overwrite=overwrite,
                                 device=device)
        lg.info("extracted %s: %s", co, extraction[co])
    return extraction


def init_cell_subcell_sds(
    chunk_size: Optional[Sequence[int]] = None,
    n_folders_fs: int = 100,
    n_folders_fs_sc: int = 100,
    generate_sv_meshes: bool = True,
    overwrite: bool = False,
    load_cellorganelles_from_kd_overlaycubes: bool = False,
    transf_func_kd_overlay=None,
    max_n_jobs: Optional[int] = None,
    device=None,
) -> Dict:
    """Organelle extraction, the fused sv/organelle property-mesh scan and
    the dataset caches, in the working directory of ``global_params.config``.
    ``load_cellorganelles_from_kd_overlaycubes``, ``transf_func_kd_overlay``
    and ``max_n_jobs`` are accepted for the JAX signature and unused there
    too. ``device``: None means the CUDA card (required), ``"cpu"`` the
    plain versions.

    Returns type -> objects written, and ``"stats"``: ``extraction``
    (organelle -> :func:`kd_init`'s statistics, None where kept), ``scan``
    (the scan's statistics with ``write_seconds``) and
    ``dataset_analysis_seconds``.
    """
    lg = initialize_logging("exec_init")
    cfg = global_params.config
    if cfg.working_dir is None:
        raise ValueError("no working directory: set global_params.wd first")
    organelles = list(cfg["process_cell_organelles"])
    extraction = _extract_organelles(cfg.kd_organelle_proba_paths, cfg.kd_organelle_seg_paths,
                                     chunk_size, cfg.working_dir, overwrite, device, lg)
    counts = map_subcell_extract_props(
        cfg.kd_seg_path, cfg.kd_organelle_seg_paths, n_folders_fs=n_folders_fs,
        n_folders_fs_sc=n_folders_fs_sc, chunk_shape=chunk_size,
        generate_sv_meshes=generate_sv_meshes, overwrite=overwrite, device=device)
    t0 = time.perf_counter()
    for t in ["sv"] + organelles:
        dataset_analysis(SegmentationDataset(t, working_dir=cfg.working_dir))
    counts["stats"] = {"extraction": extraction, "scan": counts.pop("stats"),
                       "dataset_analysis_seconds": time.perf_counter() - t0}
    lg.info("init_cell_subcell_sds done: %s",
            {k: v for k, v in counts.items() if k != "stats"})
    return counts


def run_create_rag() -> Dict[str, np.ndarray]:
    """Prune the initial supervoxel graph (``init_svgraph_path``): drop
    connected components whose bounding-box diagonal is below
    ``min_cc_size_ssv``; every supervoxel of the ``sv`` dataset takes part,
    singletons included. Writes ``pruned_svgraph.bz2`` and returns it as
    ``{"edges", "nodes"}``: each undirected edge once, as (lower, higher)
    id, and the kept nodes in ascending order."""
    lg = initialize_logging("exec_init")
    cfg = global_params.config
    g = load_svgraph(cfg.init_svgraph_path)
    sd_sv = SegmentationDataset("sv", working_dir=cfg.working_dir)
    nodes = np.union1d(g["nodes"], np.asarray(sd_sv.ids, np.uint64))
    scale = np.array(cfg["scaling"], np.float64)
    bbs = {int(i): bb * scale[None] for i, bb in zip(sd_sv.ids, sd_sv.bounding_boxes)}
    ccsize = create_ccsize_dict({"edges": g["edges"], "nodes": nodes}, bbs)
    min_cc = float(cfg["min_cc_size_ssv"])
    keep = np.array([n for n in nodes.tolist() if ccsize.get(int(n), 0) >= min_cc], np.uint64)
    edges = np.sort(g["edges"], axis=1)
    edges = np.unique(edges[np.isin(edges[:, 0], keep)], axis=0).reshape(-1, 2)
    pruned = {"edges": edges.astype(np.uint64), "nodes": keep}
    save_svgraph(pruned, cfg.pruned_svgraph_path)
    lg.info("run_create_rag: %d -> %d SVs after size pruning (min diag %.0f nm)",
            len(nodes), len(keep), min_cc)
    return pruned


def run_create_neuron_ssd(overwrite: bool = False, apply_ssv_size_threshold: bool = False,
                          device=None, stats: Optional[dict] = None):
    """Cell assembly: the connected components of the neuron graph (written
    by step 3's astrocyte splitting), else of the pruned graph, become SSVs
    (id = smallest member SV id); writes the SSD's attribute dicts, caches
    and reverse index, each cell's SV graph and, for the config's
    ``process_cell_organelles``, the aggregated organelle mappings and the
    mapping decisions. Host work; ``device`` is checked as for every entry
    point (None means the card). ``stats`` (optional dict) receives the
    cells and the seconds of each part."""
    from ..proc.graphs import component_lists, induced_subgraph
    from ..proc.ssd_proc import aggregate_segmentation_object_mappings, apply_mapping_decisions
    from ..reps.super_segmentation import SuperSegmentationDataset, save_dataset_deep

    lg = initialize_logging("exec_init")
    default_device(device)
    t0 = time.perf_counter()
    cfg = global_params.config
    path = cfg.neuron_svgraph_path
    if not os.path.isfile(path):
        path = cfg.pruned_svgraph_path
    g = load_svgraph(path)
    mapping = {c[0]: np.array(c, np.uint64) for c in component_lists(g)}
    ssd = SuperSegmentationDataset(working_dir=cfg.working_dir, sv_mapping=mapping, create=True)
    save_dataset_deep(ssd)
    t1 = time.perf_counter()
    for ssv_id, members in mapping.items():
        ssv = ssd.get_super_segmentation_object(ssv_id)
        os.makedirs(ssv.ssv_dir, exist_ok=True)
        ssv.save_sv_graph(induced_subgraph(g, members))
    t2 = time.perf_counter()
    organelles = list(cfg["process_cell_organelles"])
    if organelles:
        aggregate_segmentation_object_mappings(ssd, organelles)
    t3 = time.perf_counter()
    if organelles:
        apply_mapping_decisions(ssd, organelles)
    t4 = time.perf_counter()
    if stats is not None:
        stats.update(cells=len(mapping), graph=os.path.basename(path), seconds=t4 - t0,
                     dataset_seconds=t1 - t0, sv_graph_seconds=t2 - t1,
                     mapping_aggregation_seconds=t3 - t2, mapping_decision_seconds=t4 - t3)
    lg.info("run_create_neuron_ssd: %d cells", len(mapping))
    return ssd


def init_cell_subcell_tables(kd_seg_path: str, prob_paths: Dict[str, str],
                             seg_paths: Dict[str, str],
                             chunk_size: Optional[Sequence[int]] = None,
                             cache_root: Optional[str] = None, overwrite: bool = False,
                             device=None) -> Dict:
    """The extraction and scan of :func:`init_cell_subcell_sds` on explicit
    paths, for every organelle of the config's ``process_cell_organelles``,
    with its ``cell_objects`` settings; no meshes, nothing written but the
    segmentations.

    ``prob_paths``/``seg_paths``: organelle -> probability map / target
    segmentation. A target that exists and whose step cache is complete is
    kept unless ``overwrite``; an incomplete one resumes per chunk.
    ``cache_root``: the step caches (default: each target's parent).

    Returns :func:`..proc.sd_proc.map_subcell_extract_props_tables`' result
    with ``"extraction"``: organelle -> the stats of :func:`kd_init` (None
    where the segmentation was kept)."""
    cfg = global_params.config
    organelles = list(cfg["process_cell_organelles"])
    if chunk_size is None:
        chunk_size = cfg["tpu"]["chunk_shape"]
    extraction = _extract_organelles(prob_paths, {co: seg_paths[co] for co in organelles},
                                     chunk_size, cache_root, overwrite, device, log)
    res = map_subcell_extract_props_tables(
        kd_seg_path, {co: seg_paths[co] for co in organelles}, chunk_shape=chunk_size,
        min_obj_vx=cfg["cell_objects"]["min_obj_vx"], cache_root=cache_root,
        overwrite=overwrite, device=device)
    res["extraction"] = extraction
    return res
