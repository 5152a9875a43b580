"""Astrocyte (glia) separation from the pruned supervoxel graph
(counterpart of ``syconn_tpu/proc/glia_splitting.py``). Graphs are the
port's ``{"edges", "nodes"}`` dicts (``io/graph.py``)."""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np

from .. import global_params
from ..io.graph import load_svgraph, save_svgraph
from ..reps.segmentation import SegmentationDataset
from .graphs import component_lists, induced_subgraph, remove_glia_nodes

log = logging.getLogger("syconn_tpu_torch.glia")

__all__ = ["run_glia_splitting", "collect_glia_sv", "write_astrocyte_svgraph"]


def run_glia_splitting() -> Dict[str, int]:
    """Partition the pruned supervoxel graph into neuron and astrocyte
    subgraphs by the SVs' glia probabilities (attribute ``glia_probas``,
    or the dataset cache ``glia_probas``) and write both."""
    cfg = global_params.config
    g = load_svgraph(cfg.pruned_svgraph_path)
    sd_sv = SegmentationDataset("sv", working_dir=cfg.working_dir)
    probas = {}
    ids = sd_sv.ids
    cached = sd_sv.load_numpy_data("glia_probas")
    if cached is not None:
        probas = dict(zip(ids.tolist(), np.asarray(cached, np.float64).tolist()))
    else:
        for i in ids:
            so = sd_sv.get_segmentation_object(int(i))
            probas[int(i)] = float(so.lookup_in_attribute_dict("glia_probas", 0.0) or 0.0)
    scale = np.array(cfg["scaling"], np.float64)
    bbs = {int(i): bb * scale[None] for i, bb in zip(ids, sd_sv.bounding_boxes)}
    thresh = float(cfg["glia"]["glia_thresh"])
    min_cc = float(cfg["min_cc_size_ssv"])
    neuron_nodes, glia_nodes = [], []
    for comp in component_lists(g):
        nn_, gn_ = remove_glia_nodes(induced_subgraph(g, comp), probas, thresh, min_cc, bbs=bbs)
        neuron_nodes.extend(nn_)
        glia_nodes.extend(gn_)
    save_svgraph(induced_subgraph(g, neuron_nodes), cfg.neuron_svgraph_path)
    save_svgraph(induced_subgraph(g, glia_nodes), cfg.astrocyte_svgraph_path)
    log.info("glia splitting: %d neuron SVs, %d astrocyte SVs",
             len(neuron_nodes), len(glia_nodes))
    if len(neuron_nodes) == 0 and len(glia_nodes) > 0:
        log.warning(
            "glia splitting removed EVERY supervoxel (%d glia, 0 neurons): the glia model "
            "at %s is likely untrained or glia_thresh=%.3f is too low; the connectome will "
            "be empty", len(glia_nodes), cfg.mpath_glia_pts, thresh)
    return {"n_neuron_sv": len(neuron_nodes), "n_glia_sv": len(glia_nodes)}


def collect_glia_sv() -> np.ndarray:
    """IDs of the SVs assigned to astrocytes."""
    cfg = global_params.config
    g = load_svgraph(cfg.astrocyte_svgraph_path)
    return np.array(sorted(int(n) for n in g["nodes"]), np.uint64)


def write_astrocyte_svgraph(*a, **kw):
    """Kept for the API: the split writes both graphs directly."""
    return run_glia_splitting()
