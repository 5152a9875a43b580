"""SSD processing: organelle mapping aggregation and decisions, a cell
split in two by hand (``split_ssv``), and the synapses of each cell
(counterpart of ``syconn_tpu/proc/ssd_proc.py``).
"""

from __future__ import annotations

import logging
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import global_params
from ..parallel.executor import map_parallel
from ..reps.segmentation import SegmentationDataset
from ..reps.super_segmentation import SuperSegmentationDataset

log = logging.getLogger("syconn_tpu_torch.ssd_proc")

__all__ = ["aggregate_segmentation_object_mappings", "apply_mapping_decisions", "split_ssv",
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


def split_ssv(ssv, split_sv_ids: Sequence[int]):
    """Split an assembled cell into two (merge-error correction, the inverse
    of assembly), as the JAX package does.

    ``split_sv_ids`` must be a nonempty proper subset of ``ssv.sv_ids``: the
    other SVs form the first new cell, these the second, under the two
    smallest ids the dataset does not use. Bookkeeping:

    * each new cell's attribute dict: ``sv_ids``, ``size``,
      ``bounding_box``, ``rep_coord`` from the SV dataset, and per organelle
      type ``mapping_{co}_ids/ratios`` summed over its SVs;
    * SV graphs: the induced subgraphs of the cell's graph, stored in
      networkx's edge order and orientation (``AdjacencyGraph.subgraph``);
    * the skeleton, if any: each node goes to the side of its nearest SV
      rep coord, edges within a side are kept;
    * the dataset: ``mapping_dict``, the ``{attr}s.npy`` caches and the
      reverse index ``sv2ssv.npz``; the old cell's attribute entry becomes
      a ``split_into`` tombstone.

    Returns the two new :class:`SuperSegmentationObject` (the remaining side
    first). Meshes need nothing: a cell's mesh is merged from its SVs'.
    """
    from scipy.spatial import cKDTree

    from ..backend import AttributeDict
    from ..reps.rep_helper import subfold_from_ix
    from .graphs import AdjacencyGraph

    ssd = ssv._ssd
    if ssd is None:
        raise ValueError("SSV dataset has to be defined; instantiate via "
                         "SuperSegmentationDataset.get_super_segmentation_object")
    orig = [int(s) for s in ssv.sv_ids]
    split = {int(s) for s in split_sv_ids}
    if not split or not split < set(orig):
        raise ValueError("split_sv_ids must be a nonempty proper subset of the SSV's SVs")
    side1 = [s for s in orig if s not in split]
    side2 = [s for s in orig if s in split]

    existing = {int(i) for i in ssd.ssv_ids}
    new_ids = []
    cand = 1
    while len(new_ids) < 2:
        if cand not in existing:
            new_ids.append(cand)
        cand += 1
    id1, id2 = new_ids

    # ---------------------------------------------------- per-side attributes
    sd_sv = SegmentationDataset("sv", working_dir=ssd.working_dir, config=ssd.config)
    sv_ids_all = sd_sv.ids
    sizes = dict(zip(sv_ids_all.tolist(), sd_sv.sizes.tolist()))
    bbs = dict(zip(sv_ids_all.tolist(), sd_sv.bounding_boxes))
    reps = dict(zip(sv_ids_all.tolist(), sd_sv.rep_coords))

    cfg = ssd.config if ssd.config is not None else global_params.config
    obj_types = [co for co in list(cfg["process_cell_organelles"])
                 if sd_sv.load_numpy_data(f"mapping_{co}_ids") is not None]
    per_sv_map = {}
    for co in obj_types:
        m_ids = sd_sv.load_numpy_data(f"mapping_{co}_ids")
        m_ratios = sd_sv.load_numpy_data(f"mapping_{co}_ratios")
        per_sv_map[co] = dict(zip(sv_ids_all.tolist(), zip(m_ids, m_ratios)))

    def side_attrs(sid, svs):
        size = int(sum(sizes.get(s, 0) for s in svs))
        boxes = np.array([bbs[s] for s in svs if s in bbs])
        bb = (np.array([boxes[:, 0].min(axis=0), boxes[:, 1].max(axis=0)])
              if len(boxes) else np.zeros((2, 3), np.int64))
        largest = max(svs, key=lambda s: sizes.get(s, 0))
        attrs = {
            "id": int(sid),
            "sv_ids": np.asarray(svs, np.uint64),
            "size": size,
            "bounding_box": np.asarray(bb, np.int64),
            "rep_coord": np.asarray(reps.get(largest, np.zeros(3)), np.int64),
        }
        for co in obj_types:
            acc: Dict[int, float] = defaultdict(float)
            for s in svs:
                entry = per_sv_map[co].get(s)
                if entry is None:
                    continue
                for i, r in zip(np.atleast_1d(entry[0]), np.atleast_1d(entry[1])):
                    acc[int(i)] += float(r)
            ids_sorted = np.array(sorted(acc), np.uint64)
            attrs[f"mapping_{co}_ids"] = ids_sorted
            attrs[f"mapping_{co}_ratios"] = np.array([acc[int(i)] for i in ids_sorted])
        return attrs

    # ----------------------------------------------------------- sv graphs
    gd = ssv.load_sv_graph()
    g = AdjacencyGraph()
    for n in np.asarray(gd["nodes"]).tolist():
        g.add_node(int(n))
    for a, b in np.asarray(gd["edges"]).reshape(-1, 2).tolist():
        g.add_edge(int(a), int(b))
    side_graphs = []
    for side in (side1, side2):
        sub = g.subgraph(side)
        side_graphs.append({"edges": np.asarray(sub.edges(), np.uint64).reshape(-1, 2),
                            "nodes": np.asarray(list(sub.nodes), np.uint64)})

    # ------------------------------------------------------ skeleton split
    skels = (None, None)
    if ssv.load_skeleton() and ssv.skeleton is not None and len(
            np.atleast_2d(ssv.skeleton.get("nodes", np.zeros((0, 3))))):
        sk = ssv.skeleton
        nodes = np.atleast_2d(np.asarray(sk["nodes"], np.float64))
        sv_pts = np.array([reps[s] for s in orig if s in reps], np.float64)
        sv_side = np.array([0 if s not in split else 1 for s in orig if s in reps])
        if len(sv_pts):
            _, nearest = cKDTree(sv_pts).query(nodes)
            node_side = sv_side[nearest]
            edges = np.atleast_2d(np.asarray(sk.get("edges", np.zeros((0, 2), np.int64))))
            diam = np.asarray(sk.get("diameters", np.zeros(len(nodes))))
            out = []
            for side in (0, 1):
                keep = np.where(node_side == side)[0]
                remap = -np.ones(len(nodes), np.int64)
                remap[keep] = np.arange(len(keep))
                e = edges[(node_side[edges[:, 0]] == side) & (node_side[edges[:, 1]] == side)] \
                    if len(edges) else edges
                out.append({
                    "nodes": nodes[keep].astype(np.float32),
                    "edges": remap[e].astype(np.int64) if len(e) else np.zeros((0, 2), np.int64),
                    "diameters": diam[keep],
                })
            skels = tuple(out)

    # -------------------------------------------------------- materialize
    new_ssvs = []
    for sid, svs, gg, sk in ((id1, side1, side_graphs[0], skels[0]),
                             (id2, side2, side_graphs[1], skels[1])):
        sso = ssd.get_super_segmentation_object(sid)
        sso._sv_ids = np.asarray(svs, np.uint64)
        sso.attr_dict.update(side_attrs(sid, svs))
        sso.save_attr_dict()
        sso.save_sv_graph(gg)
        if sk is not None and len(sk["nodes"]):
            sso.skeleton = sk
            sso.save_skeleton()
        new_ssvs.append(sso)

    # the tombstone tells readers of the old id where its SVs went
    shard = subfold_from_ix(int(ssv.id), 100)
    ad = AttributeDict(os.path.join(ssd.path, "so_storage", shard.strip("/"), "attr_dict.pkl"),
                       read_only=False)
    ad[ssv.id] = {"id": int(ssv.id), "split_into": (int(id1), int(id2))}
    ad.push()

    # ------------------------------------------------- dataset bookkeeping
    md = ssd.mapping_dict
    md.pop(int(ssv.id), None)
    md[int(id1)] = np.asarray(side1, np.uint64)
    md[int(id2)] = np.asarray(side2, np.uint64)
    ssd.save_mapping_dict()

    ids_cache = ssd.load_numpy_data("id")
    if ids_cache is not None:
        keep = ids_cache != np.uint64(ssv.id)
        new_rows = {
            "id": np.array([id1, id2], np.uint64),
            "size": np.array([a.attr_dict["size"] for a in new_ssvs], np.int64),
            "bounding_box": np.array([a.attr_dict["bounding_box"] for a in new_ssvs], np.int64),
            "rep_coord": np.array([a.attr_dict["rep_coord"] for a in new_ssvs], np.int64),
        }
        sv_rows = np.empty(2, object)
        sv_rows[:] = [a.attr_dict["sv_ids"] for a in new_ssvs]
        new_rows["sv_id"] = sv_rows
        new_ids_arr = np.concatenate([ids_cache[keep], new_rows["id"]])
        order = np.argsort(new_ids_arr)
        for attr in ("id", "size", "bounding_box", "rep_coord", "sv_id"):
            cache = ssd.load_numpy_data(attr)
            if cache is None:
                continue
            merged = np.concatenate([cache[keep], new_rows[attr]])
            ssd.save_numpy_data(attr, merged[order])
    ssd.build_sv2ssv_index()
    return new_ssvs[0], new_ssvs[1]


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
