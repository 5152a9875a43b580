"""Synapse pipeline orchestration — step 6 (counterpart of
``syconn_tpu/exec/exec_syns.py``).

Only the first stage of ``run_syn_generation`` is ported: contact-site and
synapse-fragment extraction. Agglomeration, organelle mapping and the
probability assignment need the ``SegmentationDataset`` layer, which the
port does not have yet. Paths are explicit arguments: the YAML
working-directory configuration is not ported yet.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

from ..extraction.cs_extraction import extract_contact_sites

log = logging.getLogger("syconn_tpu_torch.exec_syns")

__all__ = ["run_contact_extraction"]


def run_contact_extraction(kd_seg_path: str, out_dir: str, kd_sj_path: Optional[str] = None,
                           kd_sym_path: Optional[str] = None, kd_asym_path: Optional[str] = None,
                           chunk_size: Optional[Sequence[int]] = None, overwrite: bool = False,
                           **kw) -> Dict:
    """Contact-site + synapse-fragment extraction over the segmentation at
    ``kd_seg_path``; label volumes go to ``out_dir/cs_seg`` and
    ``out_dir/syn_seg``. Map paths that are given but do not exist are
    treated as absent, as the JAX package treats its configured paths.
    Further keywords (``stencil``, ``min_obj_vx``, ``kernel``, ``device`` …)
    go to :func:`extract_contact_sites`, whose result is returned."""
    def present(p):
        return p if p is not None and os.path.isdir(p) else None

    if chunk_size is not None:
        kw["chunk_shape"] = chunk_size
    sym, asym = present(kd_sym_path), present(kd_asym_path)
    if sym is None or asym is None:
        sym = asym = None
    res = extract_contact_sites(kd_seg_path, out_dir, kd_sj_path=present(kd_sj_path),
                                kd_sym_path=sym, kd_asym_path=asym, overwrite=overwrite, **kw)
    log.info("contact sites: %d cs, %d syn", res["n_cs"], res["n_syn"])
    return res
