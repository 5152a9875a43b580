"""View rendering of whole cells (counterpart of
``syconn_tpu/exec/exec_render.py``): :func:`run_neuron_rendering` renders
and stores the default views of every cell, largest first;
:func:`run_astrocyte_rendering` does the same for the connected components
of the pruned supervoxel graph (a temporary ``gliapred`` SSD, the input of
the view-based glia prediction).

A cell's views are stored in its shard's ``views.pkl`` (``reps/views.py::
ViewContainer`` at ``ssv.ssv_dir``) under the key ``(cell id, "raw")``.
The JAX package stores them under ``"raw"`` alone, and the cells of one
shard then overwrite each other's views (whichever thread writes last
wins); the per-cell key keeps each cell's own.

Both take ``device`` (``None``: the CUDA card, which must exist) and an
optional ``stats`` dict (cells, locations, the renderer's calls, frames and
device seconds, wall seconds). Cells are rendered on four host threads; the
renderer's device part takes turns (``render.raster.DEVICE_LOCK``), the PCA
rotations, mesh loads and writes run in parallel.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from .. import global_params
from ..handler.config import initialize_logging
from ..utils.device import DeviceLike, default_device

__all__ = ["run_neuron_rendering", "run_astrocyte_rendering"]


def _render_all(ssd, ssv_ids, device, stats, save_locations: bool) -> int:
    from ..parallel.executor import map_parallel
    from ..render.views import render_sampled_sso
    from ..reps.views import ViewContainer

    t0 = time.perf_counter()

    def work(ssv_id):
        st = {}
        ssv = ssd.get_super_segmentation_object(int(ssv_id))
        views, locs = render_sampled_sso(ssv, device=device, stats=st)
        if len(views) == 0:
            return 0, st
        ViewContainer(ssv.ssv_dir).save_views(views, view_key=(ssv.id, "raw"))
        if save_locations:
            ssv.attr_dict["view_locations"] = locs
            ssv.save_attr_dict()
        st["locations"] = len(locs)
        return 1, st

    res = map_parallel(work, list(ssv_ids), n_workers=4)
    n = sum(r[0] for r in res)
    if stats is not None:
        for _, st in res:
            for k, v in st.items():
                stats[k] = stats.get(k, 0) + v
        stats.update(cells=n, seconds=time.perf_counter() - t0)
    return n


def run_neuron_rendering(max_n_jobs: Optional[int] = None, device: DeviceLike = None,
                         stats: Optional[dict] = None) -> int:
    """Render and persist the default views (``views.view_properties``) of
    every cell in descending size order, with their ``view_locations`` in
    the cell's attribute dict. Returns the number of cells with views."""
    lg = initialize_logging("exec_render")
    dev = default_device(device)
    from ..reps.super_segmentation import SuperSegmentationDataset

    cfg = global_params.config
    ssd = SuperSegmentationDataset(working_dir=cfg.working_dir)
    sizes = ssd.load_numpy_data("size")
    order = np.argsort(sizes)[::-1] if sizes is not None else np.arange(len(ssd.ssv_ids))
    n = _render_all(ssd, np.asarray(ssd.ssv_ids)[order], dev, stats, save_locations=True)
    lg.info("rendered views for %d cells", n)
    return n


def run_astrocyte_rendering(max_n_jobs: Optional[int] = None, device: DeviceLike = None,
                            stats: Optional[dict] = None) -> int:
    """Views of the pruned graph's connected components (scipy components,
    each keyed by its smallest SV) in a ``gliapred`` SSD. Returns the number
    of components with views."""
    lg = initialize_logging("exec_render")
    dev = default_device(device)
    from ..io.graph import load_svgraph
    from ..proc.graphs import component_lists
    from ..reps.super_segmentation import SuperSegmentationDataset

    cfg = global_params.config
    g = load_svgraph(cfg.pruned_svgraph_path)
    mapping = {c[0]: np.array(c, np.uint64) for c in component_lists(g)}
    tmp_ssd = SuperSegmentationDataset(working_dir=cfg.working_dir, version="gliapred",
                                       sv_mapping=mapping, create=True)
    n = _render_all(tmp_ssd, sorted(mapping), dev, stats, save_locations=False)
    lg.info("rendered astrocyte-candidate views for %d components", n)
    return n
