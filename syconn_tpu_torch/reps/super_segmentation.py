"""SuperSegmentationObject / SuperSegmentationDataset — whole cells
(counterpart of ``syconn_tpu/reps/super_segmentation.py``).

An SSV ("super supervoxel") is an agglomerated set of cell supervoxels; the
dataset holds the ssv -> sv mapping, aggregated per-cell attribute caches
and the reverse sv -> ssv lookup. Storage layout as the JAX package's:

    {wd}/ssv_{version}/
        mapping_dict.pkl                       ssv id -> sv ids
        {attr}s.npy                            dataset-level numpy caches
        sv2ssv.npz                             reverse index (BinarySearchStore)
        so_storage/{shard}/attr_dict.pkl       per-cell attributes
        so_storage/{shard}/mesh_{type}.pkl     merged meshes per object type
        so_storage/{shard}/skeletons.pkl
        so_storage/{shard}/{id}_svgraph.pkl    pickled edge list

The reverse index is the one difference: the JAX package writes an HDF5
``sv2ssv.h5``, the port (no h5py on the card machine) a numpy archive of the
same arrays under its own name (``backend/bst.py``). SV graphs are the
port's ``{"edges", "nodes"}`` dicts (``io/graph.py``); the file keeps the
JAX package's format, a pickled list of (sv, sv) edges.

The point-model and view-model predictions, rendering and the cell helpers
of steps 7-9 are here (each device method takes ``device``: ``None`` is the
CUDA card); the kzip export methods raise ``NotImplementedError`` naming
their ROADMAP item.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..backend import AttributeDict, BinarySearchStore, MeshStorage, SkeletonStorage
from ..handler.basics import load_pkl2obj, write_obj2pkl
from .rep_helper import SegmentationBase, subfold_from_ix
from .segmentation import SegmentationDataset, SegmentationObject

__all__ = ["SuperSegmentationObject", "SuperSegmentationDataset", "save_dataset_deep"]

_NO_KZIP = ("kzip export of cells is not ported yet: ROADMAP Queue 1, item 14 (cell editing "
            "and kzip)")


class SuperSegmentationObject(SegmentationBase):
    def __init__(
        self,
        ssv_id: int,
        version=None,
        working_dir: Optional[str] = None,
        config=None,
        scaling=None,
        sv_ids: Optional[Sequence[int]] = None,
        ssd: Optional["SuperSegmentationDataset"] = None,
        mesh_caching: bool = True,
    ):
        self._id = int(ssv_id)
        self._ssd = ssd
        if ssd is not None:
            self._setup_working_dir(ssd.working_dir, ssd.config, version, ssd.scaling)
            self._version = ssd.version
        else:
            self._setup_working_dir(working_dir, config, version, scaling)
            self._version = version if version is not None else self._default_version()
        self.attr_dict: Dict[str, Any] = {}
        self._sv_ids = np.asarray(sv_ids, np.uint64) if sv_ids is not None else None
        self._meshes: Dict[str, list] = {}
        self._mesh_caching = mesh_caching
        self.skeleton: Optional[dict] = None
        self._sv_graph: Optional[Dict[str, np.ndarray]] = None
        self._sd_cache: Dict[str, SegmentationDataset] = {}

    def _default_version(self):
        try:
            return self.config["versions"]["ssv"]
        except Exception:
            return 0

    # ------------------------------------------------------------- identity
    @property
    def id(self) -> int:
        return self._id

    @property
    def version(self):
        return self._version

    @property
    def type(self) -> str:
        return "ssv"

    # ----------------------------------------------------------------- paths
    @property
    def ssd_dir(self) -> str:
        return os.path.join(str(self.working_dir), f"ssv_{self.version}")

    @property
    def ssv_dir(self) -> str:
        return os.path.join(
            self.ssd_dir, "so_storage", subfold_from_ix(self.id, 100).strip("/")
        )

    @property
    def attr_dict_path(self) -> str:
        return os.path.join(self.ssv_dir, "attr_dict.pkl")

    def mesh_path(self, obj_type: str = "sv") -> str:
        return os.path.join(self.ssv_dir, f"mesh_{obj_type}.pkl")

    @property
    def skeleton_path(self) -> str:
        return os.path.join(self.ssv_dir, "skeletons.pkl")

    @property
    def skeleton_kzip_path(self) -> str:
        return os.path.join(self.ssv_dir, f"{self.id}_skeleton.k.zip")

    # ------------------------------------------------------------ attributes
    def load_attr_dict(self) -> Dict:
        if os.path.isfile(self.attr_dict_path):
            ad = AttributeDict(self.attr_dict_path, read_only=True, disable_locking=True)
            if self.id in ad:
                self.attr_dict.update(ad[self.id])
        return self.attr_dict

    def save_attr_dict(self):
        ad = AttributeDict(self.attr_dict_path, read_only=False)
        merged = dict(ad[self.id])
        merged.update(self.attr_dict)
        ad[self.id] = merged
        ad.push()

    def attr_exists(self, key: str) -> bool:
        if key in self.attr_dict:
            return True
        self.load_attr_dict()
        return key in self.attr_dict

    def lookup_in_attribute_dict(self, key: str, default=None):
        if key not in self.attr_dict:
            self.load_attr_dict()
        return self.attr_dict.get(key, default)

    def save_attributes(self, keys: Sequence[str], values: Sequence):
        for k, v in zip(keys, values):
            self.attr_dict[k] = v
        self.save_attr_dict()

    # ------------------------------------------------------------------- svs
    @property
    def sv_ids(self) -> np.ndarray:
        if self._sv_ids is None:
            v = self.lookup_in_attribute_dict("sv_ids")
            if v is None and self._ssd is not None:
                v = self._ssd.mapping_dict.get(self.id)
            self._sv_ids = np.asarray(v, np.uint64) if v is not None else np.zeros(0, np.uint64)
        return self._sv_ids

    def get_seg_dataset(self, obj_type: str) -> SegmentationDataset:
        if obj_type not in self._sd_cache:
            self._sd_cache[obj_type] = SegmentationDataset(
                obj_type, working_dir=self.working_dir, config=self.config
            )
        return self._sd_cache[obj_type]

    def get_seg_objects(self, obj_type: str) -> List[SegmentationObject]:
        sd = self.get_seg_dataset(obj_type)
        if obj_type == "sv":
            ids = self.sv_ids
        else:
            ids = self.lookup_in_attribute_dict(obj_type, [])
        return [sd.get_segmentation_object(int(i)) for i in np.asarray(ids, np.uint64)]

    @property
    def svs(self) -> List[SegmentationObject]:
        return self.get_seg_objects("sv")

    @property
    def mis(self):
        return self.get_seg_objects("mi")

    @property
    def vcs(self):
        return self.get_seg_objects("vc")

    @property
    def sjs(self):
        return self.get_seg_objects("sj")

    @property
    def syn_ssv(self):
        return self.get_seg_objects("syn_ssv")

    # ------------------------------------------------------------ aggregates
    @property
    def size(self) -> int:
        v = self.lookup_in_attribute_dict("size")
        if v is not None:
            return int(v)
        return int(sum(sv.size for sv in self.svs))

    @property
    def bounding_box(self) -> np.ndarray:
        v = self.lookup_in_attribute_dict("bounding_box")
        if v is not None:
            return np.asarray(v)
        boxes = np.array([sv.bounding_box for sv in self.svs])
        return np.array([boxes[:, 0].min(axis=0), boxes[:, 1].max(axis=0)])

    @property
    def rep_coord(self) -> np.ndarray:
        v = self.lookup_in_attribute_dict("rep_coord")
        if v is not None:
            return np.asarray(v)
        svs = self.svs
        sizes = [sv.size for sv in svs]
        return svs[int(np.argmax(sizes))].rep_coord

    # ---------------------------------------------------------------- meshes
    def load_mesh(self, obj_type: str = "sv"):
        """The merged mesh of this cell's objects of ``obj_type``, cached in
        ``mesh_{obj_type}.pkl`` after the first merge."""
        if obj_type in self._meshes:
            return self._meshes[obj_type]
        p = self.mesh_path(obj_type)
        mesh = None
        if os.path.isfile(p):
            ms = MeshStorage(p, read_only=True, disable_locking=True)
            if self.id in ms:
                mesh = ms[self.id]
        if mesh is None:
            from ..proc.meshes import merge_someshes

            sos = self.get_seg_objects(obj_type)
            mesh = merge_someshes(sos)
            ms = MeshStorage(p, read_only=False)
            ms[self.id] = mesh
            ms.push()
        if self._mesh_caching:
            self._meshes[obj_type] = mesh
        return mesh

    @property
    def mesh(self):
        return self.load_mesh("sv")

    @property
    def mi_mesh(self):
        return self.load_mesh("mi")

    @property
    def vc_mesh(self):
        return self.load_mesh("vc")

    @property
    def sj_mesh(self):
        return self.load_mesh("sj")

    def mesh_area(self) -> float:
        from ..mesh.surface_nets import mesh_area

        m = self.mesh
        return mesh_area(m[0], m[1])

    # -------------------------------------------------------------- skeleton
    def load_skeleton(self) -> bool:
        if self.skeleton is not None:
            return True
        if os.path.isfile(self.skeleton_path):
            ss = SkeletonStorage(self.skeleton_path, read_only=True, disable_locking=True)
            if self.id in ss:
                self.skeleton = ss[self.id]
                return True
        return False

    def save_skeleton(self):
        if self.skeleton is None:
            raise ValueError("No skeleton set.")
        ss = SkeletonStorage(self.skeleton_path, read_only=False)
        ss[self.id] = self.skeleton
        ss.push()

    def total_edge_length(self) -> float:
        """Skeleton cable length in nm."""
        if not self.load_skeleton():
            return 0.0
        sk = self.skeleton
        scale = np.asarray(self.scaling, np.float64)
        nodes = np.asarray(sk["nodes"], np.float64) * scale[None]
        edges = np.asarray(sk["edges"], np.int64).reshape(-1, 2)
        if len(edges) == 0:
            return 0.0
        return float(np.linalg.norm(nodes[edges[:, 0]] - nodes[edges[:, 1]], axis=1).sum())

    # -------------------------------------------------------------- sv graph
    @property
    def sv_graph_path(self) -> str:
        return os.path.join(self.ssv_dir, f"{self.id}_svgraph.pkl")

    def load_sv_graph(self) -> Dict[str, np.ndarray]:
        """The cell's SV graph dict: the stored edges over ``sv_ids``, or,
        without a stored graph, a chain in id order (one component)."""
        if self._sv_graph is not None:
            return self._sv_graph
        ids = np.asarray(self.sv_ids, np.uint64)
        if os.path.isfile(self.sv_graph_path):
            edges = np.asarray(load_pkl2obj(self.sv_graph_path), np.uint64).reshape(-1, 2)
        else:
            edges = np.stack([ids[:-1], ids[1:]], axis=1) if len(ids) > 1 else \
                np.zeros((0, 2), np.uint64)
        self._sv_graph = {"edges": edges, "nodes": ids}
        return self._sv_graph

    def save_sv_graph(self, g: Dict[str, np.ndarray]):
        """Write the graph's edges as the JAX package does: a pickled list of
        (int, int) tuples."""
        edges = np.asarray(g["edges"], np.uint64).reshape(-1, 2)
        write_obj2pkl(self.sv_graph_path, [(int(a), int(b)) for a, b in edges])
        self._sv_graph = g

    # ------------------------------------------------------------- locations
    def sample_locations(self, cache: bool = True, ds_factor: Optional[float] = None) -> List[np.ndarray]:
        """Per-SV surface sample locations in nm."""
        v = self.lookup_in_attribute_dict("sample_locations")
        if v is not None:
            return v
        locs = [sv.sample_locations(ds_factor) for sv in self.svs]
        if cache:
            self.attr_dict["sample_locations"] = locs
        return locs

    def gliasplit(self, glia_thresh: Optional[float] = None):
        """Partition this cell's SV graph into neuron/astrocyte parts by the
        SVs' glia probabilities. Returns (neuron_sv_ids, glia_sv_ids)."""
        from ..proc.graphs import remove_glia_nodes

        cfg = self.config
        if glia_thresh is None:
            glia_thresh = float(cfg["glia"]["glia_thresh"])
        probas = {}
        bbs = {}
        scale = np.asarray(self.scaling, np.float64)
        for sv in self.svs:
            sv.load_attr_dict()
            probas[sv.id] = float(sv.attr_dict.get("glia_probas", 0.0) or 0.0)
            bbs[sv.id] = sv.bounding_box * scale[None]
        g = self.load_sv_graph()
        neuron, glia = remove_glia_nodes(
            g, probas, glia_thresh, float(cfg["min_cc_size_ssv"]), bbs=bbs
        )
        return np.asarray(neuron, np.uint64), np.asarray(glia, np.uint64)

    # ------------------------------------------------------------ prediction
    @property
    def celltype(self):
        return self.lookup_in_attribute_dict("celltype_cnn_e3")

    @property
    def certainty_celltype(self):
        return self.lookup_in_attribute_dict("celltype_cnn_e3_certainty")

    def predict_celltype(self, *args, **kw):
        """The cell type of this cell by the celltype point net
        (``device`` keyword: None means the CUDA card)."""
        from ..inference.points import predict_celltype_sso

        return predict_celltype_sso(self, *args, **kw)

    def semseg_for_coords(self, coords_vx, semseg_key: str = "axoness", **kw):
        from .super_segmentation_helper import semseg_for_coords

        return semseg_for_coords(self, coords_vx, semseg_key=semseg_key, **kw)

    def axoness_for_coords(self, coords_vx, **kw):
        return self.semseg_for_coords(coords_vx, semseg_key="axoness", **kw)

    def shortestpath2soma(self, coords_vx, **kw):
        from .super_segmentation_helper import shortestpath2soma

        return shortestpath2soma(self, coords_vx, **kw)

    def syn_sign_ratio(self, **kw) -> float:
        from .super_segmentation_helper import syn_sign_ratio_celltype

        return syn_sign_ratio_celltype(self, **kw)

    def get_spine_compartments(
        self,
        semseg_key: str = "spiness",
        k: int = 1,
        min_spine_cc_size: Optional[int] = None,
        dest_folder: Optional[str] = None,
    ):
        """Connected components of the vertex spine predictions: vertices
        are linked within ``min_edge_dist_spine_graph`` nm, edges between
        differently labeled vertices are cut, and the same-label components
        of at least ``min_spine_cc_size`` vertices yield per-spine locations.

        Returns (neck_coords_vx, neck_sizes, head_coords_vx, head_sizes).
        """
        from scipy import sparse, spatial
        from scipy.sparse.csgraph import connected_components as _cc

        cfg = self.config
        if min_spine_cc_size is None:
            min_spine_cc_size = int(cfg["spines"]["min_spine_cc_size"])
        max_dist = float(cfg["spines"]["min_edge_dist_spine_graph"])
        labels = np.asarray(self.lookup_in_attribute_dict(f"{semseg_key}_vertex_labels", []))
        mesh = self.load_mesh("sv")
        verts = np.asarray(mesh[1], np.float64).reshape(-1, 3)
        empty = (np.zeros((0, 3), np.uint64), np.zeros(0, np.int64))
        if len(verts) == 0 or len(labels) != len(verts):
            return empty[0], empty[1], empty[0].copy(), empty[1].copy()
        tree = spatial.cKDTree(verts)
        pairs = tree.query_pairs(max_dist, output_type="ndarray")
        if len(pairs):
            pairs = pairs[labels[pairs[:, 0]] == labels[pairs[:, 1]]]
        n = len(verts)
        g = sparse.coo_matrix((np.ones(len(pairs), np.int8), (pairs[:, 0], pairs[:, 1])),
                              shape=(n, n))
        n_cc, cc = _cc(g.tocsr(), directed=False)
        sizes = np.bincount(cc, minlength=n_cc)
        scale = np.asarray(self.scaling, np.float64)
        out = {0: ([], []), 1: ([], [])}  # neck, head
        for c in np.flatnonzero(sizes >= min_spine_cc_size):
            sel = cc == c
            lab = int(labels[np.flatnonzero(sel)[0]])
            if lab not in out:
                continue
            out[lab][0].append(verts[sel].mean(axis=0) / scale)
            out[lab][1].append(int(sel.sum()))
        neck_c = np.asarray(out[0][0], np.float64).reshape(-1, 3).astype(np.uint64)
        head_c = np.asarray(out[1][0], np.float64).reshape(-1, 3).astype(np.uint64)
        neck_s = np.asarray(out[0][1], np.int64)
        head_s = np.asarray(out[1][1], np.int64)
        if dest_folder is not None:
            os.makedirs(dest_folder, exist_ok=True)
            np.save(f"{dest_folder}/neck_coords_ssv{self.id}_k{k}_{semseg_key}_"
                    f"ccsize{min_spine_cc_size}.npy", neck_c)
            np.save(f"{dest_folder}/head_coords_ssv{self.id}_k{k}_{semseg_key}_"
                    f"ccsize{min_spine_cc_size}.npy", head_c)
        return neck_c, neck_s, head_c, head_s

    def compartmentalize_mesh(self, semseg_key: str = "axoness"):
        from ..proc.meshes import compartmentalize_mesh

        return compartmentalize_mesh(self, semseg_key=semseg_key)

    def predict_celltype_multiview(self, **kw):
        """Cell type from rendered views (``celltype_cnn_e3``)."""
        from ..inference.views_infer import celltype_of_sso_views

        return celltype_of_sso_views(self, **kw)

    def predict_semseg(self, semseg_key: str = "axoness", **kw):
        """Per-vertex and per-node labels from rendered views."""
        from ..inference.views_infer import semseg_of_sso_views

        return semseg_of_sso_views(self, semseg_key=semseg_key, **kw)

    def predict_views_embedding(self, **kw):
        """Morphology embedding from rendered views (``latent_morph``)."""
        from ..inference.views_infer import view_embedding_of_sso

        return view_embedding_of_sso(self, **kw)

    def render_views(self, coords_nm=None, **kw):
        """Depth views at ``coords_nm``, else at the sampled locations."""
        from ..render.views import render_sampled_sso, render_sso_coords

        if coords_nm is None:
            return render_sampled_sso(self, **kw)[0]
        return render_sso_coords(self, coords_nm, **kw)

    def render_indexviews(self, coords_nm, **kw):
        """Cell-mesh vertex index views at ``coords_nm``."""
        from ..render.views import render_sso_coords_index_views

        return render_sso_coords_index_views(self, coords_nm, **kw)

    # ----------------------------------------------------------------- kzip
    def skeleton_to_kzip(self, *args, **kw):
        raise NotImplementedError(_NO_KZIP)

    def mesh2kzip(self, *args, **kw):
        raise NotImplementedError(_NO_KZIP)

    def meshes2kzip(self, *args, **kw):
        raise NotImplementedError(_NO_KZIP)

    def export2kzip(self, *args, **kw):
        raise NotImplementedError(_NO_KZIP)

    def mergelist2kzip(self, *args, **kw):
        raise NotImplementedError(_NO_KZIP)

    def write_locations2kzip(self, *args, **kw):
        raise NotImplementedError(_NO_KZIP)

    def write_svmeshes2kzip(self, *args, **kw):
        raise NotImplementedError(_NO_KZIP)

    def __repr__(self):
        return f"SuperSegmentationObject(id={self.id}, version={self.version})"


class SuperSegmentationDataset(SegmentationBase):
    def __init__(
        self,
        working_dir: Optional[str] = None,
        version=None,
        config=None,
        scaling=None,
        sv_mapping: Optional[Dict[int, Sequence[int]]] = None,
        create: bool = False,
    ):
        self._setup_working_dir(working_dir, config, version, scaling)
        if version is None:
            try:
                version = self.config["versions"]["ssv"]
            except Exception:
                version = 0
        self._version = version
        self._mapping_dict: Optional[Dict[int, np.ndarray]] = None
        self._numpy_cache: Dict[str, np.ndarray] = {}
        self._bst: Optional[BinarySearchStore] = None
        if create:
            os.makedirs(self.path, exist_ok=True)
        if sv_mapping is not None:
            self._mapping_dict = {
                int(k): np.asarray(v, np.uint64) for k, v in sv_mapping.items()
            }
            self.save_mapping_dict()

    @property
    def version(self):
        return self._version

    @property
    def path(self) -> str:
        return os.path.join(str(self.working_dir), f"ssv_{self.version}")

    @property
    def mapping_dict_path(self) -> str:
        return os.path.join(self.path, "mapping_dict.pkl")

    @property
    def sv2ssv_path(self) -> str:
        return os.path.join(self.path, "sv2ssv.npz")

    def exists(self) -> bool:
        return os.path.isfile(self.mapping_dict_path)

    # ---------------------------------------------------------------- mapping
    @property
    def mapping_dict(self) -> Dict[int, np.ndarray]:
        if self._mapping_dict is None:
            if os.path.isfile(self.mapping_dict_path):
                self._mapping_dict = load_pkl2obj(self.mapping_dict_path)
            else:
                self._mapping_dict = {}
        return self._mapping_dict

    def save_mapping_dict(self):
        os.makedirs(self.path, exist_ok=True)
        write_obj2pkl(self.mapping_dict_path, self._mapping_dict)

    @property
    def ssv_ids(self) -> np.ndarray:
        arr = self.load_numpy_data("id")
        if arr is not None:
            return arr
        return np.array(sorted(self.mapping_dict.keys()), np.uint64)

    # ----------------------------------------------------------- reverse map
    def build_sv2ssv_index(self):
        """sv -> ssv reverse lookup (:class:`BinarySearchStore`)."""
        sv_ids, ssv_ids = [], []
        for ssv, svs in self.mapping_dict.items():
            sv_ids.append(np.asarray(svs, np.uint64))
            ssv_ids.append(np.full(len(svs), ssv, np.uint64))
        if not sv_ids:
            return
        sv_arr = np.concatenate(sv_ids)
        ssv_arr = np.concatenate(ssv_ids)
        if os.path.isfile(self.sv2ssv_path):
            os.remove(self.sv2ssv_path)
        self._bst = BinarySearchStore(
            self.sv2ssv_path, sv_arr, {"ssv_ids": ssv_arr},
            n_shards=max(1, len(sv_arr) // 500_000 + 1))

    def sv2ssv_ids(self, sv_ids: np.ndarray) -> np.ndarray:
        if self._bst is None:
            self._bst = BinarySearchStore(self.sv2ssv_path)
        return self._bst.get_attributes(np.asarray(sv_ids, np.uint64), "ssv_ids")

    def id_changer(self, sv_ids: np.ndarray) -> np.ndarray:
        return self.sv2ssv_ids(sv_ids)

    # ------------------------------------------------------------- np caches
    def load_numpy_data(self, attr: str) -> Optional[np.ndarray]:
        if attr in self._numpy_cache:
            return self._numpy_cache[attr]
        p = os.path.join(self.path, f"{attr}s.npy")
        if not os.path.isfile(p):
            return None
        arr = np.load(p, allow_pickle=True)
        self._numpy_cache[attr] = arr
        return arr

    def save_numpy_data(self, attr: str, arr: np.ndarray):
        os.makedirs(self.path, exist_ok=True)
        np.save(os.path.join(self.path, f"{attr}s.npy"), arr)
        self._numpy_cache[attr] = arr

    # ---------------------------------------------------------------- objects
    def get_super_segmentation_object(self, ssv_id, **kw) -> SuperSegmentationObject:
        if isinstance(ssv_id, (list, np.ndarray)):
            return [self.get_super_segmentation_object(s, **kw) for s in ssv_id]
        return SuperSegmentationObject(int(ssv_id), ssd=self, **kw)

    @property
    def ssvs(self) -> Iterator[SuperSegmentationObject]:
        for i in self.ssv_ids:
            yield self.get_super_segmentation_object(int(i))

    def __repr__(self):
        return f"SuperSegmentationDataset(version={self.version}, wd={self.working_dir!r})"


def save_dataset_deep(
    ssd: SuperSegmentationDataset, n_workers: Optional[int] = None, new_mapping: bool = True
):
    """Per-SSV attribute dicts (sv_ids, size, bounding_box, rep_coord), the
    dataset-level ``{attr}s.npy`` caches and the reverse index."""
    from ..parallel.executor import map_parallel

    sd_sv = SegmentationDataset("sv", working_dir=ssd.working_dir, config=ssd.config)
    sv_ids_all = sd_sv.ids
    sizes = dict(zip(sv_ids_all.tolist(), sd_sv.sizes.tolist()))
    bbs = dict(zip(sv_ids_all.tolist(), sd_sv.bounding_boxes))
    reps = dict(zip(sv_ids_all.tolist(), sd_sv.rep_coords))

    items = sorted(ssd.mapping_dict.items())

    def agg(item):
        ssv_id, svs = item
        svs = [int(s) for s in svs]
        size = int(sum(sizes.get(s, 0) for s in svs))
        boxes = np.array([bbs[s] for s in svs if s in bbs])
        if len(boxes):
            bb = np.array([boxes[:, 0].min(axis=0), boxes[:, 1].max(axis=0)])
        else:
            bb = np.zeros((2, 3), np.int64)
        largest = max(svs, key=lambda s: sizes.get(s, 0)) if svs else None
        rep = reps.get(largest, np.zeros(3, np.int64)) if largest is not None else np.zeros(3, np.int64)
        return ssv_id, {
            "id": int(ssv_id),
            "sv_ids": np.asarray(svs, np.uint64),
            "size": size,
            "bounding_box": np.asarray(bb, np.int64),
            "rep_coord": np.asarray(rep, np.int64),
        }

    results = map_parallel(agg, items, n_workers=n_workers)

    by_shard = defaultdict(list)
    for ssv_id, attrs in results:
        by_shard[subfold_from_ix(int(ssv_id), 100)].append((ssv_id, attrs))

    def write_shard(item):
        shard, entries = item
        shard_dir = os.path.join(ssd.path, "so_storage", shard.strip("/"))
        os.makedirs(shard_dir, exist_ok=True)
        ad = AttributeDict(
            os.path.join(shard_dir, "attr_dict.pkl"), read_only=False, disable_locking=True
        )
        for ssv_id, attrs in entries:
            merged = dict(ad[ssv_id])
            merged.update(attrs)
            ad[ssv_id] = merged
        ad.push()

    map_parallel(write_shard, list(by_shard.items()), n_workers=n_workers)

    ids = np.array([r[0] for r in results], np.uint64)
    order = np.argsort(ids)
    ids = ids[order]
    res_sorted = [results[i][1] for i in order]
    ssd.save_numpy_data("id", ids)
    ssd.save_numpy_data("size", np.array([r["size"] for r in res_sorted], np.int64))
    ssd.save_numpy_data(
        "bounding_box", np.array([r["bounding_box"] for r in res_sorted], np.int64)
    )
    ssd.save_numpy_data("rep_coord", np.array([r["rep_coord"] for r in res_sorted], np.int64))
    sv_arr = np.empty(len(res_sorted), object)
    sv_arr[:] = [r["sv_ids"] for r in res_sorted]
    ssd.save_numpy_data("sv_id", sv_arr)
    ssd.build_sv2ssv_index()
