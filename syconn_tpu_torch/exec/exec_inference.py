"""Neural-inference orchestration (counterpart of
``syconn_tpu/exec/exec_inference.py``): step 3, astrocyte separation.

:func:`run_astrocyte_prediction_pts` runs the glia point net over every SV
of the pruned graph's components on the card and caches the per-SV
probabilities; :func:`run_astrocyte_splitting` splits the pruned graph into
the neuron and astrocyte graphs. Both take their paths from
``global_params.config``; ``device=None`` means the CUDA card, which must
exist (pass ``device="cpu"`` to run on the CPU).

Steps 7-9 (celltype, compartments, spines, embeddings) come with ROADMAP
Queue 1 item 8; their entry points raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from .. import global_params
from ..handler.config import initialize_logging
from ..utils.device import DeviceLike, default_device

__all__ = [
    "run_celltype_prediction",
    "run_semsegaxoness_prediction",
    "run_semsegspiness_prediction",
    "run_morphology_embedding",
    "run_cell_embedding",
    "run_astrocyte_prediction",
    "run_astrocyte_prediction_pts",
    "run_astrocyte_splitting",
]

_STEPS_7_9 = ("steps 7-9 (celltype, compartments, spines, morphology embeddings) are not "
              "ported yet: ROADMAP Queue 1, item 8")


def run_celltype_prediction(*args, **kwargs):
    raise NotImplementedError(_STEPS_7_9)


def run_semsegaxoness_prediction(*args, **kwargs):
    raise NotImplementedError(_STEPS_7_9)


def run_semsegspiness_prediction(*args, **kwargs):
    raise NotImplementedError(_STEPS_7_9)


def run_morphology_embedding(*args, **kwargs):
    raise NotImplementedError(_STEPS_7_9)


def run_cell_embedding(*args, **kwargs):
    raise NotImplementedError(_STEPS_7_9)


def run_astrocyte_prediction_pts(max_n_jobs_gpu: Optional[int] = None,
                                 device: DeviceLike = None, stats: Optional[dict] = None):
    """Per-SV glia probability via the glia point net, over the components
    of the pruned supervoxel graph (a temporary ``gliapred`` SSD); caches
    ``glia_probas`` dataset-wide. ``stats`` (optional dict) receives the
    contexts, dispatches and seconds."""
    lg = initialize_logging("exec_inference")
    dev = default_device(device)
    from ..inference.points import predict_glia_ssv
    from ..io.graph import load_svgraph
    from ..proc.graphs import component_lists
    from ..reps.segmentation import SegmentationDataset
    from ..reps.super_segmentation import SuperSegmentationDataset

    t0 = time.perf_counter()
    cfg = global_params.config
    g = load_svgraph(cfg.pruned_svgraph_path)
    mapping = {c[0]: np.array(c, np.uint64) for c in component_lists(g)}
    tmp_ssd = SuperSegmentationDataset(
        working_dir=cfg.working_dir, version="gliapred", sv_mapping=mapping, create=True)
    st = {}
    n = predict_glia_ssv(ssd=tmp_ssd, device=dev, stats=st)
    sd_sv = SegmentationDataset("sv", working_dir=cfg.working_dir)
    probas = []
    for i in sd_sv.ids:
        so = sd_sv.get_segmentation_object(int(i))
        probas.append(float(so.lookup_in_attribute_dict("glia_probas", 0.0) or 0.0))
    sd_sv.save_numpy_data("glia_probas", np.array(probas, np.float64))
    if stats is not None:
        stats.update(st, seconds=time.perf_counter() - t0, cells=len(mapping))
    lg.info("astrocyte prediction done (%d SVs)", n)
    return n


def run_astrocyte_prediction(*a, **kw):
    """The view-based variant routes to the point predictor."""
    return run_astrocyte_prediction_pts(*a, **kw)


def run_astrocyte_splitting(device: DeviceLike = None):
    """Split the pruned graph into neuron and astrocyte graphs (host work;
    ``device`` is checked as for every entry point of the port)."""
    lg = initialize_logging("exec_inference")
    default_device(device)
    from ..proc.glia_splitting import run_glia_splitting

    stats = run_glia_splitting()
    lg.info("astrocyte splitting: %s", stats)
    return stats
