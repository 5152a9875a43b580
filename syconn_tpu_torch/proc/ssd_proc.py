"""SSD processing: organelle mapping aggregation and decisions, and the
synapses of each cell (counterpart of ``syconn_tpu/proc/ssd_proc.py``).

``split_ssv`` (a cell split in two by hand) is not ported yet.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import global_params
from ..parallel.executor import map_parallel
from ..reps.segmentation import SegmentationDataset
from ..reps.super_segmentation import SuperSegmentationDataset

log = logging.getLogger("syconn_tpu_torch.ssd_proc")

__all__ = ["aggregate_segmentation_object_mappings", "apply_mapping_decisions",
           "map_synssv_objects"]


def aggregate_segmentation_object_mappings(
    ssd: SuperSegmentationDataset,
    obj_types: Sequence[str],
    n_workers: Optional[int] = None,
):
    """Sum each organelle object's per-SV overlap ratios over the SVs of
    every cell (in the cell's ``sv_ids`` order, as Python floats, so the
    sums equal the JAX package's); store ``mapping_{co}_ids`` /
    ``mapping_{co}_ratios`` on the SSV."""
    sd_sv = SegmentationDataset("sv", working_dir=ssd.working_dir, config=ssd.config)
    sv_ids = sd_sv.ids
    per_sv: Dict[str, Optional[Dict[int, tuple]]] = {}
    for co in obj_types:
        m_ids = sd_sv.load_numpy_data(f"mapping_{co}_ids")
        m_ratios = sd_sv.load_numpy_data(f"mapping_{co}_ratios")
        if m_ids is None:
            per_sv[co] = None  # fall back to the per-object attribute dicts
            continue
        per_sv[co] = dict(zip(sv_ids.tolist(), zip(m_ids, m_ratios)))

    def agg(ssv_id):
        ssv = ssd.get_super_segmentation_object(int(ssv_id))
        attrs = {}
        for co in obj_types:
            acc: Dict[int, float] = defaultdict(float)
            if per_sv[co] is not None:
                for sv in ssv.sv_ids:
                    entry = per_sv[co].get(int(sv))
                    if entry is None:
                        continue
                    ids, ratios = entry
                    for i, r in zip(np.atleast_1d(ids), np.atleast_1d(ratios)):
                        acc[int(i)] += float(r)
            else:
                for sv in ssv.svs:
                    sv.load_attr_dict()
                    ids = sv.attr_dict.get(f"mapping_{co}_ids", [])
                    ratios = sv.attr_dict.get(f"mapping_{co}_ratios", [])
                    for i, r in zip(np.atleast_1d(ids), np.atleast_1d(ratios)):
                        acc[int(i)] += float(r)
            ids_sorted = np.array(sorted(acc.keys()), np.uint64)
            attrs[f"mapping_{co}_ids"] = ids_sorted
            attrs[f"mapping_{co}_ratios"] = np.array([acc[int(i)] for i in ids_sorted])
        ssv.attr_dict.update(attrs)
        ssv.save_attr_dict()
        return ssv_id

    map_parallel(agg, list(ssd.ssv_ids), n_workers=n_workers)


def apply_mapping_decisions(
    ssd: SuperSegmentationDataset,
    obj_types: Sequence[str],
    n_workers: Optional[int] = None,
):
    """Finalize per-cell organelle lists: an object is mapped if its overlap
    ratio lies in [lower, upper] and it passes the size threshold
    (config ``cell_objects``)."""
    cfg = ssd.config if ssd.config is not None else global_params.config
    lower = cfg["cell_objects"]["lower_mapping_ratios"]
    upper = cfg["cell_objects"]["upper_mapping_ratios"]
    sizeths = cfg["cell_objects"]["sizethresholds"]

    sizes_by_type = {}
    for co in obj_types:
        sd = SegmentationDataset(co, working_dir=ssd.working_dir, config=ssd.config)
        sizes_by_type[co] = dict(zip(sd.ids.tolist(), sd.sizes.tolist()))

    def decide(ssv_id):
        ssv = ssd.get_super_segmentation_object(int(ssv_id))
        ssv.load_attr_dict()
        for co in obj_types:
            ids = np.atleast_1d(ssv.attr_dict.get(f"mapping_{co}_ids", np.zeros(0, np.uint64)))
            ratios = np.atleast_1d(ssv.attr_dict.get(f"mapping_{co}_ratios", np.zeros(0)))
            lo = float(lower.get(co, 0.5))
            up = float(upper.get(co, 1.0))
            sth = int(sizeths.get(co, 0))
            keep = []
            for i, r in zip(ids, ratios):
                if r < lo or r > up:
                    continue
                if sizes_by_type[co].get(int(i), 0) < sth:
                    continue
                keep.append(int(i))
            ssv.attr_dict[co] = np.array(sorted(keep), np.uint64)
        ssv.save_attr_dict()
        return ssv_id

    map_parallel(decide, list(ssd.ssv_ids), n_workers=n_workers)


def map_synssv_objects(
    ssd: Optional[SuperSegmentationDataset] = None,
    n_workers: Optional[int] = None,
):
    """Write each cell's syn_ssv ids (sorted) into its attribute dict
    (``syn_ssv``): the inversion of the synapses' ``neuron_partners``."""
    if ssd is None:
        ssd = SuperSegmentationDataset(working_dir=global_params.config.working_dir)
    sd_syn = SegmentationDataset("syn_ssv", working_dir=ssd.working_dir, config=ssd.config)
    syn_ids = sd_syn.ids
    partners = sd_syn.load_numpy_data("neuron_partners")
    per_ssv: Dict[int, List[int]] = defaultdict(list)
    if partners is not None:
        for syn_id, pp in zip(syn_ids, partners):
            for p in np.atleast_1d(pp):
                per_ssv[int(p)].append(int(syn_id))

    def write(ssv_id):
        ssv = ssd.get_super_segmentation_object(int(ssv_id))
        ssv.load_attr_dict()
        ssv.attr_dict["syn_ssv"] = np.array(sorted(per_ssv.get(int(ssv_id), [])), np.uint64)
        ssv.save_attr_dict()
        return ssv_id

    map_parallel(write, list(ssd.ssv_ids), n_workers=n_workers)
