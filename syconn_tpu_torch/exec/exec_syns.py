"""Synapse pipeline orchestration — step 6 (counterpart of
``syconn_tpu/exec/exec_syns.py``).

:func:`run_syn_generation` runs its first stage, contact-site and
synapse-fragment extraction into the working directory's 'cs' and 'syn'
datasets. The stages after it (agglomeration into ``syn_ssv``, organelle
mapping, the probability assignment) need ``extraction/cs_processing.py``
and the cell datasets, which the port does not have yet (ROADMAP Queue 1,
item 7); they raise. :func:`run_contact_extraction` is the first stage on
explicit paths, returning the merged tables.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

from ..extraction.cs_extraction import extract_contact_site_tables, extract_contact_sites
from ..handler.config import initialize_logging

log = logging.getLogger("syconn_tpu_torch.exec_syns")

__all__ = ["run_syn_generation", "run_contact_extraction"]


def run_syn_generation(chunk_size: Optional[Sequence[int]] = None, n_folders_fs: int = 100,
                       overwrite: bool = False, cube_of_interest_bb=None,
                       until: Optional[str] = None, **kw) -> Dict:
    """Contact-site + synapse extraction and what follows it. Only the first
    stage is ported: ``until="extract_contact_sites"`` runs it (further
    keywords, ``device``, ``kernel`` …, go to
    :func:`..extraction.cs_extraction.extract_contact_sites`) and returns
    its result; a run through later stages (``until=None``, all of them, as
    the JAX function runs) raises ``NotImplementedError`` before it starts.
    ``cube_of_interest_bb`` is accepted for the JAX signature and unused
    there too."""
    if until != "extract_contact_sites":
        raise NotImplementedError(
            f"run_syn_generation(until={until!r}): the stages after extract_contact_sites "
            "(combine_and_split_syn, map_objects_from_synssv_partners, "
            "classify_synssv_objects, map_synssv_objects) need cs_processing and the cell "
            "datasets, which are not ported yet (ROADMAP Queue 1, item 7)")
    lg = initialize_logging("exec_syns")
    stats = extract_contact_sites(chunk_shape=chunk_size, n_folders_fs=n_folders_fs,
                                  overwrite=overwrite, **kw)
    lg.info("contact sites: %d cs, %d syn", stats["n_cs"], stats["n_syn"])
    return stats


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
