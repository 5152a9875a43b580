"""Synapse agglomeration (syn -> syn_ssv), contact agglomeration (cs ->
cs_ssv), organelle mapping, classification and the connectivity export —
pipeline steps 6, 6.5 and the matrix export (counterpart of
``syconn_tpu/extraction/cs_processing.py``, the same numpy/scipy code).

``combine_and_split_syn`` groups the 'syn' fragments by the pair of cells
they join, clusters each pair's voxels at ``cs_gap_nm`` and writes one
``syn_ssv`` object per cluster (ids in ``(partners, rep_coord)`` order,
so the voxel order of the fragments decides them, as in the JAX package).
``map_objects_from_synssv_partners`` counts each partner cell's mi/vc near
every synapse, ``classify_synssv_objects`` assigns ``syn_prob`` (a pickled
random forest at ``mpath_syn_rfc`` where one exists, else the JAX package's
heuristic), ``combine_and_split_cs`` builds ``cs_ssv`` from the 'cs'
fragments. ``collect_properties_from_ssv_partners`` and ``export_matrix``
write the per-partner cell type, axoness and spiness and the CSV/NPZ matrix.
``create_syn_rfc`` trains and pickles that forest with scikit-learn,
imported when it is called (where it is missing, as on the card machine, it
raises ``ImportError``).
"""

from __future__ import annotations

import logging
import os
import pickle
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy import ndimage, spatial

from .. import global_params
from ..backend import AttributeDict, MeshStorage, VoxelStorageLazyLoading
from ..ops.contacts import cs_pair_unpack
from ..parallel.executor import map_parallel
from ..reps.rep_helper import subfold_from_ix
from ..reps.segmentation import SegmentationDataset
from ..reps.super_segmentation import SuperSegmentationDataset

log = logging.getLogger("syconn_tpu_torch.cs_processing")

__all__ = [
    "filter_relevant_syn",
    "combine_and_split_syn",
    "combine_and_split_cs",
    "connected_cluster_kdtree",
    "map_objects_from_synssv_partners",
    "classify_synssv_objects",
    "create_syn_rfc",
    "synssv_o_features",
    "synssv_o_featurenames",
    "collect_properties_from_ssv_partners",
    "export_matrix",
]


# --------------------------------------------------------------- clustering
def connected_cluster_kdtree(
    coords_nm: np.ndarray, gap_nm: float, exact_limit: Optional[int] = None
) -> np.ndarray:
    """Cluster coordinates by single linkage at about ``gap_nm``; returns
    cluster labels (N,).

    The linkage runs on an occupancy grid of cell size gap/3: occupied
    cells are dilated by one and connected-component labeled, so two points
    join when their cells are at most two apart (reach ~1.15 x gap). An
    exact KD-tree linkage is quadratic on dense voxel lists; ``exact_limit``
    is accepted for the JAX signature and ignored there too.
    """
    n = len(coords_nm)
    if n == 0:
        return np.zeros(0, np.int64)
    cell = max(gap_nm / 3.0, 1.0)
    q = np.floor(np.asarray(coords_nm, np.float64) / cell).astype(np.int64)
    lo = q.min(axis=0)
    q -= lo
    sh = q.max(axis=0) + 3
    occ = np.zeros(tuple(sh), bool)
    occ[q[:, 0] + 1, q[:, 1] + 1, q[:, 2] + 1] = True
    occ = ndimage.binary_dilation(occ, structure=np.ones((3, 3, 3), bool))
    lab, _ = ndimage.label(occ, structure=np.ones((3, 3, 3), bool))
    return lab[q[:, 0] + 1, q[:, 1] + 1, q[:, 2] + 1].astype(np.int64)


def filter_relevant_syn(
    sd_syn: SegmentationDataset, ssd: SuperSegmentationDataset
) -> Dict[Tuple[int, int], List[int]]:
    """Group syn (or cs) fragments by their (ssv_a, ssv_b) partner pair;
    fragments between SVs of the same cell, or of SVs in no cell, are
    dropped."""
    syn_ids = sd_syn.ids
    if len(syn_ids) == 0:
        return {}
    lo, hi = cs_pair_unpack(syn_ids)
    known = set(int(s) for svs in ssd.mapping_dict.values() for s in svs)
    out: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    sel = [i for i in range(len(syn_ids)) if int(lo[i]) in known and int(hi[i]) in known]
    if not sel:
        return {}
    lo_ssv = ssd.sv2ssv_ids(lo[sel])
    hi_ssv = ssd.sv2ssv_ids(hi[sel])
    for k, i in enumerate(sel):
        a, b = int(lo_ssv[k]), int(hi_ssv[k])
        if a == b:
            continue
        key = (min(a, b), max(a, b))
        out[key].append(int(syn_ids[i]))
    return out


def _load_syn_voxels(sd_syn: SegmentationDataset, syn_id: int) -> np.ndarray:
    """An object's voxel list in its stored row order."""
    shard = subfold_from_ix(syn_id, sd_syn.n_folders_fs)
    p = os.path.join(sd_syn.so_storage_path, shard.strip("/"), "voxel_lazy.npz")
    vl = VoxelStorageLazyLoading(p)
    if syn_id in vl:
        return np.asarray(vl[syn_id], np.int64)
    return np.zeros((0, 3), np.int64)


def _write_numpy_caches(sd_out: SegmentationDataset, all_objs: List[dict], keys) -> None:
    sd_out.save_numpy_data("id", np.array([o["id"] for o in all_objs], np.uint64))
    for key, dtype in keys:
        sd_out.save_numpy_data(key, np.array([o[key] for o in all_objs], dtype))
    sd_out.save_numpy_data(
        "neuron_partners",
        np.array([o["neuron_partners"] for o in all_objs], np.uint64).reshape(-1, 2))


def _number_by_shard(all_objs: List[dict], n_folders_fs: int) -> Dict[str, List[dict]]:
    """Ids 1..n in ``(partners, rep_coord)`` order, grouped by storage shard."""
    all_objs.sort(key=lambda o: (int(o["neuron_partners"][0]), int(o["neuron_partners"][1]),
                                 tuple(o["rep_coord"])))
    by_shard: Dict[str, List[dict]] = defaultdict(list)
    for k, obj in enumerate(all_objs):
        obj["id"] = k + 1
        by_shard[subfold_from_ix(k + 1, n_folders_fs)].append(obj)
    return by_shard


def combine_and_split_syn(
    n_workers: Optional[int] = None,
    n_folders_fs: int = 100,
    overwrite: bool = True,
) -> Dict:
    """Agglomerate SV-level syn fragments into cell-level ``syn_ssv``
    objects: per partner pair, the fragments' voxels (concatenated in
    fragment-id order) are clustered at ``cs_gap_nm``; each cluster of at
    least ``min_obj_vx['syn_ssv']`` voxels becomes an object with
    size-weighted ``asym_prop``/``sym_prop``, ``syn_sign`` (-1 where the
    symmetric ratio exceeds ``sym_thresh``), voxels and a mesh. Returns the
    object and partner-pair counts.

    With ``overwrite=False`` completed partner pairs resume from the step
    cache ``<wd>/.stepcache/syn_agglomerate``."""
    from ..proc.meshes import triangulation_from_coords
    from ..utils.stepcache import StepCache, cached_map

    cfg = global_params.config
    wd = cfg.working_dir
    pair_cache = StepCache("syn_agglomerate", wd, overwrite=overwrite)
    sd_syn = SegmentationDataset("syn", working_dir=wd)
    ssd = SuperSegmentationDataset(working_dir=wd)
    gap_nm = float(cfg["cell_objects"]["cs_gap_nm"])
    scale = np.array(cfg["scaling"], np.float64)
    min_vx = int(cfg["cell_objects"]["min_obj_vx"].get("syn_ssv", 1))
    sym_thresh = float(cfg["cell_objects"]["sym_thresh"])
    mesh_props = cfg["meshes"]["meshing_props_points"]["syn_ssv"]

    groups = filter_relevant_syn(sd_syn, ssd)
    asym_props = dict(zip(sd_syn.ids.tolist(), sd_syn.load_numpy_data("asym_prop")))
    sym_props = dict(zip(sd_syn.ids.tolist(), sd_syn.load_numpy_data("sym_prop")))
    sizes = dict(zip(sd_syn.ids.tolist(), sd_syn.sizes.tolist()))

    def work(item):
        (ssv_a, ssv_b), frag_ids = item
        vox = []
        frag_of = []
        for fid in frag_ids:
            v = _load_syn_voxels(sd_syn, fid)
            vox.append(v)
            frag_of.append(np.full(len(v), fid, np.uint64))
        if not vox:
            return []
        coords = np.concatenate(vox)
        frag_of = np.concatenate(frag_of)
        if len(coords) == 0:
            return []
        labels = connected_cluster_kdtree(coords * scale[None], gap_nm)
        out = []
        for lab in np.unique(labels):
            sel = labels == lab
            cc = coords[sel]
            if len(cc) < min_vx:
                continue
            members = np.unique(frag_of[sel])
            w = np.array([sizes.get(int(m), 1) for m in members], np.float64)
            a_prop = float(np.average([asym_props.get(int(m), 0.0) for m in members], weights=w))
            s_prop = float(np.average([sym_props.get(int(m), 0.0) for m in members], weights=w))
            denom = a_prop + s_prop
            sym_ratio = s_prop / denom if denom > 0 else -1.0
            syn_sign = -1 if sym_ratio > sym_thresh else 1
            bb = np.array([cc.min(axis=0), cc.max(axis=0) + 1], np.int64)
            rep = cc[len(cc) // 2]
            out.append(dict(
                neuron_partners=np.array([ssv_a, ssv_b], np.uint64),
                coords=cc,
                bounding_box=bb,
                rep_coord=np.asarray(rep, np.int64),
                size=int(len(cc)),
                asym_prop=a_prop,
                sym_prop=s_prop,
                syn_sign=syn_sign,
                id_cs_ratio=1.0,
                cs_ids=members,
            ))
        return out

    all_objs: List[dict] = []
    for out in cached_map(work, sorted(groups.items()), pair_cache,
                          key_fn=lambda kv: f"{int(kv[0][0])}_{int(kv[0][1])}",
                          n_workers=n_workers):
        all_objs.extend(out)
    pair_cache.mark_complete()
    by_shard = _number_by_shard(all_objs, n_folders_fs)
    sd_out = SegmentationDataset("syn_ssv", working_dir=wd, n_folders_fs=n_folders_fs,
                                 create=True)
    vox_size = float(mesh_props.get("voxel_size_simplify", 20))

    def write_shard(item):
        shard, objs = item
        shard_dir = os.path.join(sd_out.so_storage_path, shard.strip("/"))
        os.makedirs(shard_dir, exist_ok=True)
        ad = AttributeDict(os.path.join(shard_dir, "attr_dict.pkl"), read_only=False,
                           disable_locking=True)
        vl = VoxelStorageLazyLoading(os.path.join(shard_dir, "voxel_lazy.npz"))
        ms = MeshStorage(os.path.join(shard_dir, "mesh.pkl"), read_only=False,
                         disable_locking=True)
        for obj in objs:
            oid = obj["id"]
            coords = obj.pop("coords")
            ad[oid] = dict(obj)
            vl[oid] = coords
            ms[oid] = triangulation_from_coords(coords * scale[None], voxel_size_nm=vox_size)
        ad.push()
        vl.push()
        ms.push()

    map_parallel(write_shard, list(by_shard.items()), n_workers=n_workers)
    _write_numpy_caches(sd_out, all_objs, [
        ("size", np.int64), ("rep_coord", np.int64), ("bounding_box", np.int64),
        ("syn_sign", np.int64), ("asym_prop", np.float64), ("sym_prop", np.float64)])
    log.info("combine_and_split_syn: %d syn_ssv objects", len(all_objs))
    return {"n_syn_ssv": len(all_objs), "n_pairs": len(groups)}


def combine_and_split_cs(n_workers: Optional[int] = None, n_folders_fs: int = 100) -> Dict:
    """Agglomerate contact sites into cell-level ``cs_ssv`` objects: per
    partner pair, the fragments' rep coords are clustered at 4 x
    ``cs_gap_nm`` (cs fragments store no voxel lists)."""
    cfg = global_params.config
    wd = cfg.working_dir
    sd_cs = SegmentationDataset("cs", working_dir=wd)
    ssd = SuperSegmentationDataset(working_dir=wd)
    gap_nm = float(cfg["cell_objects"]["cs_gap_nm"])
    scale = np.array(cfg["scaling"], np.float64)

    groups = filter_relevant_syn(sd_cs, ssd)
    reps = dict(zip(sd_cs.ids.tolist(), sd_cs.rep_coords))
    sizes = dict(zip(sd_cs.ids.tolist(), sd_cs.sizes.tolist()))
    bbs = dict(zip(sd_cs.ids.tolist(), sd_cs.bounding_boxes))

    all_objs = []
    for (a, b), frag_ids in sorted(groups.items()):
        coords = np.array([reps[f] for f in frag_ids], np.float64)
        labels = connected_cluster_kdtree(coords * scale[None], gap_nm * 4)
        for lab in np.unique(labels):
            sel = np.flatnonzero(labels == lab)
            members = [frag_ids[i] for i in sel]
            bb_arr = np.array([bbs[m] for m in members])
            all_objs.append(dict(
                neuron_partners=np.array([a, b], np.uint64),
                bounding_box=np.array([bb_arr[:, 0].min(0), bb_arr[:, 1].max(0)], np.int64),
                rep_coord=np.asarray(reps[members[0]], np.int64),
                size=int(sum(sizes[m] for m in members)),
                cs_ids=np.array(members, np.uint64),
            ))
    by_shard = _number_by_shard(all_objs, n_folders_fs)
    sd_out = SegmentationDataset("cs_ssv", working_dir=wd, n_folders_fs=n_folders_fs,
                                 create=True)

    def write_shard(item):
        shard, objs = item
        shard_dir = os.path.join(sd_out.so_storage_path, shard.strip("/"))
        os.makedirs(shard_dir, exist_ok=True)
        ad = AttributeDict(os.path.join(shard_dir, "attr_dict.pkl"), read_only=False,
                           disable_locking=True)
        for obj in objs:
            ad[obj["id"]] = obj
        ad.push()

    map_parallel(write_shard, list(by_shard.items()), n_workers=n_workers)
    _write_numpy_caches(sd_out, all_objs, [
        ("size", np.int64), ("rep_coord", np.int64), ("bounding_box", np.int64)])
    return {"n_cs_ssv": len(all_objs), "n_pairs": len(groups)}


# ----------------------------------------------------------- object mapping
def _map_objects_to_single_synssv(
    syn_tree: "spatial.cKDTree",
    seg_objs: List,
    max_vert_dist_nm: float,
    sample_fact: int = 2,
) -> Tuple[int, float, float]:
    """For each candidate organelle, the fraction of its (subsampled) mesh
    vertices within ``max_vert_dist_nm`` of the synapse voxels estimates
    its close-by voxels (frac * size). Returns (objects with a close
    surface, estimated close voxels, min distance in nm)."""
    min_dist = 1e12
    n_obj_vxs = []
    for obj in seg_objs:
        mesh = obj.mesh
        verts = (
            np.asarray(mesh[1], np.float64).reshape(-1, 3)[::sample_fact]
            if mesh is not None and len(mesh[1])
            else np.asarray(obj.voxel_list[::sample_fact], np.float64) * obj.scaling[None]
        )
        if len(verts) == 0:
            n_obj_vxs.append(0.0)
            continue
        ds, _ = syn_tree.query(verts, distance_upper_bound=max_vert_dist_nm)
        close_frac = float(np.sum(np.isfinite(ds))) / len(verts)
        d_min = float(np.min(ds))
        if np.isfinite(d_min) and d_min < min_dist:
            min_dist = d_min
        n_obj_vxs.append(close_frac * float(obj.size))
    arr = np.asarray(n_obj_vxs)
    return int(np.sum(arr > 0)), float(arr.sum()), float(min_dist)


def map_objects_from_synssv_partners(n_workers: Optional[int] = None,
                                     sample_fact: int = 2) -> None:
    """Map each partner cell's mi/vc organelles to its synapses.

    Candidates are the organelles mapped to the partner cell (SSV attribute
    ``mi``/``vc``) whose rep coord lies within ``max_rep_coord_dist_nm`` of
    the synapse's; each counts by the distance of its mesh vertices to the
    synapse voxels (``max_vert_dist_nm[co]``). Stores per partner slot ``j``
    the attributes and numpy caches ``n_{co}_objs_{j}``, ``n_{co}_vxs_{j}``
    and ``min_dst_{co}_nm_{j}``."""
    cfg = global_params.config
    wd = cfg.working_dir
    sd_syn = SegmentationDataset("syn_ssv", working_dir=wd)
    ssd = SuperSegmentationDataset(working_dir=wd)
    max_dists = cfg["cell_objects"]["max_vert_dist_nm"]
    max_rep_dist = float(cfg["cell_objects"]["max_rep_coord_dist_nm"])
    scale = np.array(cfg["scaling"], np.float64)
    organelles = [co for co in ("mi", "vc") if co in cfg["process_cell_organelles"]]

    syn_ids = sd_syn.ids
    partners = sd_syn.load_numpy_data("neuron_partners")
    n = len(syn_ids)
    out = {
        co: dict(
            n_objs=np.zeros((n, 2), np.int64),
            n_vxs=np.zeros((n, 2), np.float64),
            min_dst=np.full((n, 2), 1e12, np.float64),
        )
        for co in organelles
    }

    def save_caches():
        for co in organelles:
            for j in range(2):
                sd_syn.save_numpy_data(f"n_{co}_objs_{j}", out[co]["n_objs"][:, j])
                sd_syn.save_numpy_data(f"n_{co}_vxs_{j}", out[co]["n_vxs"][:, j])
                sd_syn.save_numpy_data(f"min_dst_{co}_nm_{j}", out[co]["min_dst"][:, j])

    if n == 0 or partners is None:
        save_caches()
        return
    syn_reps = np.asarray(sd_syn.rep_coords, np.float64) * scale[None]
    obj_data = {co: SegmentationDataset(co, working_dir=wd) for co in organelles}

    def work_cell(ssv_id):
        """All synapses of one cell against that cell's organelles."""
        ssv_id = int(ssv_id)
        ssv = ssd.get_super_segmentation_object(ssv_id)
        ssv.load_attr_dict()
        rows = np.flatnonzero((partners[:, 0] == ssv_id) | (partners[:, 1] == ssv_id))
        res = []
        if len(rows) == 0:
            return res
        trees = {}
        for co in organelles:
            mapped = np.atleast_1d(np.asarray(ssv.attr_dict.get(co, []), np.uint64))
            sd_co = obj_data[co]
            if len(mapped) == 0 or len(sd_co.ids) == 0:
                trees[co] = None
                continue
            sel = np.isin(sd_co.ids, mapped)
            ids_m = sd_co.ids[sel]
            reps_m = np.asarray(sd_co.rep_coords, np.float64)[sel] * scale[None]
            trees[co] = (ids_m, spatial.cKDTree(reps_m))
        for i in rows:
            j = 0 if int(partners[i, 0]) == ssv_id else 1
            vox = _load_syn_voxels(sd_syn, int(syn_ids[i]))
            syn_pts = (np.asarray(vox[::sample_fact], np.float64) * scale[None]
                       if len(vox) else syn_reps[i][None])
            syn_tree = spatial.cKDTree(syn_pts)
            vals = {}
            for co in organelles:
                if trees[co] is None:
                    vals[co] = (0, 0.0, 1e12)
                    continue
                ids_m, tree = trees[co]
                cand_ix = tree.query_ball_point(syn_reps[i], max_rep_dist)
                cand = [obj_data[co].get_segmentation_object(int(ids_m[k])) for k in cand_ix]
                vals[co] = _map_objects_to_single_synssv(
                    syn_tree, cand, float(max_dists.get(co, 1000)), sample_fact)
            res.append((int(i), j, vals))
        return res

    for cell_res in map_parallel(work_cell, sorted(int(s) for s in ssd.ssv_ids),
                                 n_workers=n_workers):
        for i, j, vals in cell_res:
            for co in organelles:
                out[co]["n_objs"][i, j] = vals[co][0]
                out[co]["n_vxs"][i, j] = vals[co][1]
                out[co]["min_dst"][i, j] = vals[co][2]

    def update(i):
        so = sd_syn.get_segmentation_object(int(syn_ids[i]))
        so.load_attr_dict()
        for co in organelles:
            for j in range(2):
                so.attr_dict[f"n_{co}_objs_{j}"] = int(out[co]["n_objs"][i, j])
                so.attr_dict[f"n_{co}_vxs_{j}"] = float(out[co]["n_vxs"][i, j])
                so.attr_dict[f"min_dst_{co}_nm_{j}"] = float(out[co]["min_dst"][i, j])
        so.save_attr_dict()

    map_parallel(update, list(range(n)), n_workers=n_workers)
    save_caches()


# ------------------------------------------------------------ classification
def synssv_o_featurenames() -> List[str]:
    """Names of the columns of :func:`synssv_o_features`."""
    names = ["size_vx", "mesh_area_um2"]
    for j in (1, 2):
        for co in ("mi", "vc"):
            names += [f"n_{co}_objs_neuron{j}", f"n_{co}_vxs_neuron{j}",
                      f"min_dst_{co}_nm_neuron{j}"]
    return names


def synssv_o_features(sd_syn: SegmentationDataset) -> np.ndarray:
    """Feature matrix for synapse classification: size, mesh area, and per
    partner slot the mi/vc mapping features (n_objs, n_vxs, min_dst). The
    mesh areas are computed once and cached as ``mesh_area``."""
    n = len(sd_syn.ids)
    sizes = np.asarray(sd_syn.sizes, np.float64)
    area = sd_syn.load_numpy_data("mesh_area")
    if area is None:
        area = np.array([sd_syn.get_segmentation_object(int(i)).mesh_area for i in sd_syn.ids],
                        np.float64)
        sd_syn.save_numpy_data("mesh_area", area)
    cols = [sizes, np.asarray(area, np.float64)]
    for j in range(2):
        for co in ("mi", "vc"):
            for key, default in ((f"n_{co}_objs_{j}", 0.0), (f"n_{co}_vxs_{j}", 0.0),
                                 (f"min_dst_{co}_nm_{j}", 1e12)):
                v = sd_syn.load_numpy_data(key)
                cols.append(np.full(n, default) if v is None else np.asarray(v, np.float64))
    return np.stack(cols, axis=1) if n else np.zeros((0, 14))


def create_syn_rfc(features: np.ndarray, labels: np.ndarray, save_path: Optional[str] = None):
    """Train the synapse random forest (reference: :1190) and pickle it to
    ``save_path`` (where :func:`classify_synssv_objects` reads it from
    ``mpath_syn_rfc``). scikit-learn is imported here only: where it is
    missing this raises ``ImportError``."""
    from sklearn.ensemble import RandomForestClassifier

    rfc = RandomForestClassifier(n_estimators=200, max_depth=8, n_jobs=-1, random_state=0,
                                 class_weight="balanced")
    rfc.fit(features, labels)
    if save_path:
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        with open(save_path, "wb") as f:
            pickle.dump(rfc, f)
    return rfc


def classify_synssv_objects(n_workers: Optional[int] = None) -> None:
    """Assign ``syn_prob`` to every syn_ssv: the pickled random forest at
    ``config.mpath_syn_rfc`` where it exists (unpickling it needs
    scikit-learn, which raises where it is missing), otherwise the JAX
    package's heuristic on the same features (size and type evidence)."""
    cfg = global_params.config
    sd_syn = SegmentationDataset("syn_ssv", working_dir=cfg.working_dir)
    feats = synssv_o_features(sd_syn)
    rfc_path = cfg.mpath_syn_rfc
    if os.path.isfile(rfc_path):
        with open(rfc_path, "rb") as f:
            rfc = pickle.load(f)
        probs = rfc.predict_proba(feats)[:, 1]
    else:
        size_term = 1.0 - np.exp(-feats[:, 0] / 100.0)
        asym = sd_syn.load_numpy_data("asym_prop")
        sym = sd_syn.load_numpy_data("sym_prop")
        if asym is not None and sym is not None:
            type_term = np.clip(np.asarray(asym) + np.asarray(sym), 0, 1)
        else:
            type_term = np.zeros(len(feats))
        probs = np.clip(0.25 + 0.5 * size_term + 0.25 * type_term, 0, 1)
    sd_syn.save_numpy_data("syn_prob", probs.astype(np.float64))
    ids = sd_syn.ids

    def update(i):
        so = sd_syn.get_segmentation_object(int(ids[i]))
        so.load_attr_dict()
        so.attr_dict["syn_prob"] = float(probs[i])
        so.save_attr_dict()

    map_parallel(update, list(range(len(ids))), n_workers=n_workers)


# ------------------------------------------------------- partner properties
def collect_properties_from_ssv_partners(n_workers: Optional[int] = None) -> None:
    """Attach per-partner cell properties to each syn_ssv: the cell type
    (``celltype_cnn_e3``) and the axoness (``axoness_avg10000`` else
    ``axoness``) and spiness of the partner's skeleton node nearest to the
    synapse; -1 where a partner lacks them."""
    cfg = global_params.config
    wd = cfg.working_dir
    sd_syn = SegmentationDataset("syn_ssv", working_dir=wd)
    ssd = SuperSegmentationDataset(working_dir=wd)
    partners = sd_syn.load_numpy_data("neuron_partners")
    if partners is None:
        return
    scale = np.array(cfg["scaling"], np.float64)

    celltypes = {}
    skels = {}
    for ssv_id in ssd.ssv_ids:
        ssv = ssd.get_super_segmentation_object(int(ssv_id))
        ssv.load_attr_dict()
        celltypes[int(ssv_id)] = ssv.attr_dict.get("celltype_cnn_e3", -1)
        if ssv.load_skeleton():
            skels[int(ssv_id)] = ssv.skeleton

    syn_reps = np.asarray(sd_syn.rep_coords, np.float64) * scale[None]
    axoness = np.full((len(sd_syn.ids), 2), -1, np.int64)
    spiness = np.full((len(sd_syn.ids), 2), -1, np.int64)
    cts = np.full((len(sd_syn.ids), 2), -1, np.int64)
    for i, pp in enumerate(partners):
        for j, p in enumerate(pp):
            p = int(p)
            cts[i, j] = celltypes.get(p, -1)
            sk = skels.get(p)
            if sk is not None and len(sk.get("nodes", [])):
                nodes_nm = np.asarray(sk["nodes"], np.float64) * scale[None]
                d = np.linalg.norm(nodes_nm - syn_reps[i][None], axis=1)
                nearest = int(np.argmin(d))
                if "axoness_avg10000" in sk:
                    axoness[i, j] = int(np.asarray(sk["axoness_avg10000"])[nearest])
                elif "axoness" in sk:
                    axoness[i, j] = int(np.asarray(sk["axoness"])[nearest])
                if "spiness" in sk:
                    spiness[i, j] = int(np.asarray(sk["spiness"])[nearest])
    sd_syn.save_numpy_data("partner_celltypes", cts)
    sd_syn.save_numpy_data("partner_axoness", axoness)
    sd_syn.save_numpy_data("partner_spiness", spiness)
    ids = sd_syn.ids

    def update(i):
        so = sd_syn.get_segmentation_object(int(ids[i]))
        so.load_attr_dict()
        so.attr_dict["partner_celltypes"] = cts[i]
        so.attr_dict["partner_axoness"] = axoness[i]
        so.attr_dict["partner_spiness"] = spiness[i]
        so.save_attr_dict()

    map_parallel(update, list(range(len(ids))), n_workers=n_workers)


# ------------------------------------------------------------------- export
def export_matrix(dest_name: Optional[str] = None, syn_prob_t: Optional[float] = None) -> str:
    """Write the connectivity matrix: one row per synapse with ``syn_prob``
    at or above the threshold (``thresh_synssv_proba``), to
    ``<dest_name>.csv`` and ``<dest_name>.npz``. Returns the CSV path."""
    cfg = global_params.config
    wd = cfg.working_dir
    sd_syn = SegmentationDataset("syn_ssv", working_dir=wd)
    if syn_prob_t is None:
        syn_prob_t = float(cfg["cell_objects"]["thresh_synssv_proba"])
    if dest_name is None:
        dest_name = os.path.join(str(wd), "connectivity_matrix", "conn_mat")
    os.makedirs(os.path.dirname(dest_name), exist_ok=True)

    ids = sd_syn.ids
    prob = sd_syn.load_numpy_data("syn_prob")
    prob = np.ones(len(ids)) if prob is None else prob
    sel = prob >= syn_prob_t
    partners = sd_syn.load_numpy_data("neuron_partners")[sel]
    coords = np.asarray(sd_syn.rep_coords)[sel]
    sizes = np.asarray(sd_syn.sizes)[sel]
    signs = np.asarray(sd_syn.load_numpy_data("syn_sign"))[sel]
    cts = sd_syn.load_numpy_data("partner_celltypes")
    axo = sd_syn.load_numpy_data("partner_axoness")
    spi = sd_syn.load_numpy_data("partner_spiness")
    shv = sd_syn.load_numpy_data("spinehead_vol")
    n = int(sel.sum())
    cts = cts[sel] if cts is not None else np.full((n, 2), -1)
    axo = axo[sel] if axo is not None else np.full((n, 2), -1)
    spi = spi[sel] if spi is not None else np.full((n, 2), -1)
    shv = shv[sel] if shv is not None else np.zeros(n)

    header = ("id,partner_a,partner_b,coord_x,coord_y,coord_z,size_vx,syn_sign,"
              "syn_prob,ct_a,ct_b,axoness_a,axoness_b,spiness_a,spiness_b,"
              "spinehead_vol")
    rows = []
    sel_ids = ids[sel]
    sel_prob = prob[sel]
    for i in range(n):
        rows.append(
            f"{int(sel_ids[i])},{int(partners[i][0])},{int(partners[i][1])},"
            f"{int(coords[i][0])},{int(coords[i][1])},{int(coords[i][2])},"
            f"{int(sizes[i])},{int(signs[i])},{sel_prob[i]:.4f},"
            f"{int(cts[i][0])},{int(cts[i][1])},{int(axo[i][0])},{int(axo[i][1])},"
            f"{int(spi[i][0])},{int(spi[i][1])},{float(shv[i]):.6f}"
        )
    csv_path = dest_name + ".csv"
    with open(csv_path, "w") as f:
        f.write(header + "\n" + "\n".join(rows) + ("\n" if rows else ""))
    np.savez(dest_name + ".npz", ids=sel_ids, partners=partners, coords=coords, sizes=sizes,
             signs=signs, probs=sel_prob, celltypes=cts, axoness=axo, spiness=spi,
             spinehead_vol=shv)
    log.info("export_matrix: %d synapses -> %s", n, csv_path)
    return csv_path
