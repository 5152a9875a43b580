"""Synapse pipeline orchestration — steps 6, 6.5, the spine-head volumes
of step 7 and the matrix export (counterpart of
``syconn_tpu/exec/exec_syns.py``).

:func:`run_syn_generation` runs contact-site and synapse-fragment
extraction into the working directory's 'cs' and 'syn' datasets (the
contact kernel on the card), then the host stages: agglomeration into
``syn_ssv``, organelle mapping, the probability assignment and each cell's
synapse list. :func:`run_cs_ssv_generation` builds ``cs_ssv``,
:func:`run_spinehead_volume_calc` the spine-head volume per synapse, and
:func:`run_matrix_export` the connectivity matrix. Each takes its paths
from the working-directory configuration; ``device=None`` means the CUDA
card, which must exist (pass ``device="cpu"`` to run on the CPU).
:func:`run_contact_extraction` is the first stage on explicit paths,
returning the merged tables.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

from .. import global_params
from ..extraction.cs_extraction import extract_contact_site_tables, extract_contact_sites
from ..handler.config import initialize_logging
from ..utils.device import DeviceLike, default_device

log = logging.getLogger("syconn_tpu_torch.exec_syns")

__all__ = ["run_syn_generation", "run_cs_ssv_generation", "run_spinehead_volume_calc",
           "run_matrix_export", "run_contact_extraction"]


def run_syn_generation(chunk_size: Optional[Sequence[int]] = None, n_folders_fs: int = 100,
                       overwrite: bool = False, cube_of_interest_bb=None,
                       until: Optional[str] = None, device: DeviceLike = None, **kw) -> Dict:
    """Contact-site + synapse extraction, agglomeration into ``syn_ssv``,
    organelle mapping, probability assignment and the cells' synapse lists,
    as the JAX function runs them. ``until="extract_contact_sites"`` stops
    after the first stage. Further keywords (``kernel`` …) go to
    :func:`..extraction.cs_extraction.extract_contact_sites`. Returns the
    first stage's result, ``n_syn_ssv``/``n_pairs`` of the agglomeration,
    and ``stages``: seconds per stage. ``cube_of_interest_bb`` is accepted
    for the JAX signature and unused there too."""
    lg = initialize_logging("exec_syns")
    dev = default_device(device)
    from ..extraction.cs_processing import (classify_synssv_objects, combine_and_split_syn,
                                            map_objects_from_synssv_partners)
    from ..proc.sd_proc import dataset_analysis
    from ..proc.ssd_proc import map_synssv_objects
    from ..reps.segmentation import SegmentationDataset

    stages = {}
    t0 = time.perf_counter()
    stats = extract_contact_sites(chunk_shape=chunk_size, n_folders_fs=n_folders_fs,
                                  overwrite=overwrite, device=dev, **kw)
    stages["extract_contact_sites"] = time.perf_counter() - t0
    lg.info("contact sites: %d cs, %d syn", stats["n_cs"], stats["n_syn"])
    if until == "extract_contact_sites":
        return stats
    if until is not None:
        raise ValueError(f"run_syn_generation: unknown stage until={until!r}")
    t0 = time.perf_counter()
    stats2 = combine_and_split_syn(n_folders_fs=n_folders_fs, overwrite=overwrite)
    stages["combine_and_split_syn"] = time.perf_counter() - t0
    lg.info("syn_ssv: %s", stats2)
    for name, fn in (("map_objects_from_synssv_partners", map_objects_from_synssv_partners),
                     ("classify_synssv_objects", classify_synssv_objects),
                     ("map_synssv_objects", map_synssv_objects)):
        t0 = time.perf_counter()
        fn()
        stages[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dataset_analysis(SegmentationDataset("syn_ssv",
                                         working_dir=global_params.config.working_dir))
    stages["dataset_analysis"] = time.perf_counter() - t0
    return {**stats, **stats2, "stages": stages}


def run_cs_ssv_generation(n_folders_fs: int = 100, overwrite: bool = False,
                          device: DeviceLike = None) -> Dict:
    """Cell-level contact-site objects ``cs_ssv`` (host work; ``device`` is
    checked as for every entry point of the port)."""
    lg = initialize_logging("exec_syns")
    default_device(device)
    from ..extraction.cs_processing import combine_and_split_cs

    stats = combine_and_split_cs(n_folders_fs=n_folders_fs)
    lg.info("cs_ssv: %s", stats)
    return stats


def run_spinehead_volume_calc(n_workers: Optional[int] = None, device: DeviceLike = None,
                              stats: Optional[dict] = None) -> np.ndarray:
    """Spine-head volume per synapse (µm³, ``spinehead_vol`` numpy cache of
    ``syn_ssv``, 0 where none was measured): per cell, the spiness vertex
    labels propagated into the segmentation by a distance-transform
    watershed, and the head component at each spine-head synapse
    (:func:`..reps.super_segmentation_helper.extract_spinehead_volume`).
    Cells without spiness vertex labels are skipped. ``stats`` (optional
    dict) receives the cells, the qualifying and measured synapses and the
    thread-seconds. Host work; ``device`` is checked as for every entry
    point."""
    lg = initialize_logging("exec_syns")
    default_device(device)
    from ..parallel.executor import map_parallel
    from ..reps.segmentation import SegmentationDataset
    from ..reps.super_segmentation import SuperSegmentationDataset
    from ..reps.super_segmentation_helper import extract_spinehead_volume

    cfg = global_params.config
    sd_syn = SegmentationDataset("syn_ssv", working_dir=cfg.working_dir)
    ssd = SuperSegmentationDataset(working_dir=cfg.working_dir)
    ssv_ids = ssd.ssv_ids

    def work(ssv_id):
        t0 = time.perf_counter()
        ssv = ssd.get_super_segmentation_object(int(ssv_id))
        st = {}
        try:
            vols = extract_spinehead_volume(ssv, stats=st)
        except ValueError:
            # no spiness vertex labels for this cell: nothing to measure
            return {}, st, time.perf_counter() - t0
        ssv.save_attr_dict()
        return vols, st, time.perf_counter() - t0

    per_syn: dict = {}
    qualifying = thread_s = 0
    for vols, st, sec in map_parallel(work, sorted(int(s) for s in ssv_ids),
                                      n_workers=n_workers):
        # a synapse has one post-synaptic (spine) side; where both partner
        # cells yield a head volume the larger measurement is kept
        for k, v in vols.items():
            per_syn[k] = max(v, per_syn.get(k, 0.0))
        qualifying += st.get("qualifying", 0)
        thread_s += sec
    out = np.array([per_syn.get(int(i), 0.0) for i in sd_syn.ids], np.float64)
    sd_syn.save_numpy_data("spinehead_vol", out)
    if stats is not None:
        stats.update(cells=len(ssv_ids), qualifying=qualifying, measured=len(per_syn),
                     thread_seconds=thread_s)
    lg.info("spinehead volumes computed for %d/%d synapses", int((out > 0).sum()), len(out))
    return out


def run_matrix_export(device: DeviceLike = None) -> str:
    """The partners' cell types, axoness and spiness per synapse, then the
    connectivity matrix as CSV and NPZ; returns the CSV path. Host work;
    ``device`` is checked as for every entry point."""
    lg = initialize_logging("exec_syns")
    default_device(device)
    from ..extraction.cs_processing import collect_properties_from_ssv_partners, export_matrix

    collect_properties_from_ssv_partners()
    path = export_matrix()
    lg.info("matrix exported to %s", path)
    return path


def run_contact_extraction(kd_seg_path: str, out_dir: str, kd_sj_path: Optional[str] = None,
                           kd_sym_path: Optional[str] = None, kd_asym_path: Optional[str] = None,
                           chunk_size: Optional[Sequence[int]] = None, overwrite: bool = False,
                           **kw) -> Dict:
    """Contact-site + synapse-fragment extraction over the segmentation at
    ``kd_seg_path``; label volumes go to ``out_dir/cs_seg`` and
    ``out_dir/syn_seg``. Map paths that are given but do not exist are
    treated as absent, as the JAX package treats its configured paths.
    Further keywords (``stencil``, ``min_obj_vx``, ``kernel``, ``device`` …)
    go to :func:`extract_contact_site_tables`, whose result is returned."""
    def present(p):
        return p if p is not None and os.path.isdir(p) else None

    if chunk_size is not None:
        kw["chunk_shape"] = chunk_size
    sym, asym = present(kd_sym_path), present(kd_asym_path)
    if sym is None or asym is None:
        sym = asym = None
    res = extract_contact_site_tables(kd_seg_path, out_dir, kd_sj_path=present(kd_sj_path),
                                      kd_sym_path=sym, kd_asym_path=asym, overwrite=overwrite,
                                      **kw)
    log.info("contact sites: %d cs, %d syn", res["n_cs"], res["n_syn"])
    return res
