"""SegmentationObject / SegmentationDataset — per-object data access
(counterpart of ``syconn_tpu/reps/segmentation.py``). One *object* is a supervoxel / organelle /
contact site / synapse instance; a *dataset* is the collection of all
objects of one type (``sv``, ``mi``, ``vc``, ``sj``, ``cs``, ``syn``,
``syn_ssv``, ``cs_ssv``, ``er``, ``golgi``).

Storage layout (same shape as the reference):
    {wd}/{type}s_{version}/
        so_storage/{shard}/attr_dict.pkl      per-object attributes
        so_storage/{shard}/mesh.pkl           per-object meshes
        so_storage/{shard}/voxel_dyn.pkl      bb/size/rep (voxels re-queried)
        so_storage/{shard}/skeletons.pkl
        so_storage/{shard}/views.pkl          per-object rendered views
        {attr}s.npy                           dataset-level numpy caches
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..backend import AttributeDict, MeshStorage, SkeletonStorage, VoxelStorageDyn
from .rep_helper import SegmentationBase, get_unique_subfold_ixs, subfold_from_ix

__all__ = ["SegmentationObject", "SegmentationDataset"]


class SegmentationObject(SegmentationBase):
    def __init__(
        self,
        obj_id: int,
        obj_type: str = "sv",
        version=None,
        working_dir: Optional[str] = None,
        config=None,
        scaling=None,
        n_folders_fs: Optional[int] = None,
        mesh_caching: bool = True,
        create: bool = False,
        dataset: Optional["SegmentationDataset"] = None,
    ):
        self._id = int(obj_id)
        self._type = obj_type
        self._dataset = dataset
        if dataset is not None:
            self._setup_working_dir(dataset.working_dir, dataset.config, version, dataset.scaling)
            self._version = dataset.version
            self._n_folders_fs = dataset.n_folders_fs
        else:
            self._setup_working_dir(working_dir, config, version, scaling)
            self._version = self._resolve_version(version)
            self._n_folders_fs = n_folders_fs or 100
        self.attr_dict: Dict[str, Any] = {}
        self._mesh = None
        self._mesh_caching = mesh_caching
        self._skeleton = None

    def _resolve_version(self, version):
        if version is not None:
            return version
        try:
            return self.config["versions"][self._type]
        except Exception:
            return 0

    # ------------------------------------------------------------- identity
    @property
    def id(self) -> int:
        return self._id

    @property
    def type(self) -> str:
        return self._type

    @property
    def version(self):
        return self._version

    @property
    def n_folders_fs(self) -> int:
        return self._n_folders_fs

    # ----------------------------------------------------------------- paths
    @property
    def segds_dir(self) -> str:
        return os.path.join(str(self.working_dir), f"{self.type}s_{self.version}")

    @property
    def segobj_dir(self) -> str:
        return os.path.join(
            self.segds_dir, "so_storage", subfold_from_ix(self.id, self.n_folders_fs).strip("/")
        )

    @property
    def attr_dict_path(self) -> str:
        return os.path.join(self.segobj_dir, "attr_dict.pkl")

    @property
    def mesh_path(self) -> str:
        return os.path.join(self.segobj_dir, "mesh.pkl")

    @property
    def voxel_path(self) -> str:
        return os.path.join(self.segobj_dir, "voxel_dyn.pkl")

    @property
    def skeleton_path(self) -> str:
        return os.path.join(self.segobj_dir, "skeletons.pkl")

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

    # ------------------------------------------------------------ properties
    @property
    def size(self) -> int:
        v = self.lookup_in_attribute_dict("size")
        return int(v) if v is not None else 0

    @property
    def bounding_box(self) -> np.ndarray:
        return np.asarray(self.lookup_in_attribute_dict("bounding_box"))

    @property
    def rep_coord(self) -> np.ndarray:
        return np.asarray(self.lookup_in_attribute_dict("rep_coord"))

    @property
    def shape(self) -> np.ndarray:
        bb = self.bounding_box
        return bb[1] - bb[0]

    @property
    def mesh_bb(self) -> np.ndarray:
        """Mesh bounding box in nm (falls back to voxel bb * scale)."""
        mesh = self.mesh
        if mesh is not None and len(mesh[1]):
            v = mesh[1].reshape(-1, 3)
            return np.array([v.min(axis=0), v.max(axis=0)])
        bb = self.bounding_box
        return bb * self.scaling[None]

    @property
    def mesh_size(self) -> float:
        bb = self.mesh_bb
        return float(np.linalg.norm(bb[1] - bb[0]))

    @property
    def mesh_area(self) -> float:
        from ..mesh.surface_nets import mesh_area

        mesh = self.mesh
        if mesh is None:
            return 0.0
        return mesh_area(mesh[0], mesh[1])

    # ----------------------------------------------------------------- mesh
    @property
    def mesh(self):
        if self._mesh is not None:
            return self._mesh
        mesh = self.load_mesh()
        if self._mesh_caching:
            self._mesh = mesh
        return mesh

    def load_mesh(self):
        if os.path.isfile(self.mesh_path):
            ms = MeshStorage(self.mesh_path, read_only=True, disable_locking=True)
            if self.id in ms:
                m = ms[self.id]
                return [np.asarray(m[0]), np.asarray(m[1])] + (
                    [np.asarray(m[2])] if len(m) > 2 else [np.zeros(0, np.float32)]
                )
        return self.mesh_from_scratch()

    def mesh_from_scratch(self, downsampling=None):
        """Mesh the object's voxels on the fly."""
        from ..mesh.surface_nets import surface_net_mesh

        try:
            mask, off = self.voxel_mask_offset()
        except Exception:
            return [np.zeros(0, np.int32), np.zeros(0, np.float32), np.zeros(0, np.float32)]
        if downsampling is None:
            try:
                downsampling = self.config["meshes"]["downsampling"].get(self.type, (1, 1, 1))
            except Exception:
                downsampling = (1, 1, 1)
        ind, vert, norm = surface_net_mesh(
            mask, offset=off, scale=self.scaling, downsample=downsampling
        )
        return [ind, vert, norm]

    def save_mesh(self, ind, vert, norm=None):
        ms = MeshStorage(self.mesh_path, read_only=False)
        ms[self.id] = [ind, vert, norm if norm is not None else np.zeros(0, np.float32)]
        ms.push()

    # ---------------------------------------------------------------- voxels
    def _voxel_store(self) -> VoxelStorageDyn:
        return VoxelStorageDyn(
            self.voxel_path, read_only=True, disable_locking=True
        )

    def voxel_mask_offset(self):
        vs = self._voxel_store()
        if self.id in vs:
            return vs.get_voxelmask_offset(self.id)
        # fall back to the seg volume via bounding box
        from ..handler.basics import kd_factory

        bb = self.bounding_box
        kd = kd_factory(self.config.kd_seg_path)
        seg = kd.load_seg(offset=bb[0], size=bb[1] - bb[0])
        return seg == self.id, bb[0]

    @property
    def voxels(self) -> np.ndarray:
        mask, _ = self.voxel_mask_offset()
        return mask

    @property
    def voxel_list(self) -> np.ndarray:
        mask, off = self.voxel_mask_offset()
        return np.argwhere(mask) + np.asarray(off)[None]

    def voxels_exist(self) -> bool:
        return os.path.isfile(self.voxel_path)

    # -------------------------------------------------------------- skeleton
    @property
    def skeleton(self):
        if self._skeleton is None and os.path.isfile(self.skeleton_path):
            ss = SkeletonStorage(self.skeleton_path, read_only=True, disable_locking=True)
            if self.id in ss:
                self._skeleton = ss[self.id]
        return self._skeleton

    def save_skeleton(self, skeleton: dict):
        ss = SkeletonStorage(self.skeleton_path, read_only=False)
        ss[self.id] = skeleton
        ss.push()
        self._skeleton = skeleton

    # ----------------------------------------------------------------- views
    @property
    def view_path(self) -> str:
        return os.path.join(self.segobj_dir, "views.pkl")

    def load_views(self, view_key: str = "raw") -> Optional[np.ndarray]:
        """Cached rendered views of this object; None where there are none."""
        from ..backend import CompressedStorage

        if not os.path.isfile(self.view_path):
            return None
        cs = CompressedStorage(self.view_path, read_only=True, disable_locking=True)
        key = (self.id, view_key)
        if key in cs:
            return cs[key]
        if self.id in cs:
            return cs[self.id]
        return None

    def save_views(self, views: np.ndarray, view_key: str = "raw"):
        from ..backend import CompressedStorage

        cs = CompressedStorage(self.view_path, read_only=False)
        cs[(self.id, view_key)] = np.asarray(views)
        cs.push()

    @property
    def views(self) -> Optional[np.ndarray]:
        return self.load_views()

    # ------------------------------------------------------------- locations
    def sample_locations(self, ds_factor: Optional[float] = None) -> np.ndarray:
        """Surface sample locations in nm."""
        from .rep_helper import surface_samples

        mesh = self.mesh
        if mesh is None or len(mesh[1]) == 0:
            return (self.rep_coord * self.scaling)[None].astype(np.float32)
        verts = mesh[1].reshape(-1, 3)
        if ds_factor is None:
            ds_factor = 2000
        return surface_samples(verts, bin_sizes=(ds_factor,) * 3, max_nb_samples=None)

    def __repr__(self):
        return f"SegmentationObject(id={self.id}, type='{self.type}', version={self.version})"


class SegmentationDataset(SegmentationBase):
    def __init__(
        self,
        obj_type: str,
        version=None,
        working_dir: Optional[str] = None,
        config=None,
        scaling=None,
        n_folders_fs: Optional[int] = None,
        create: bool = False,
        cache_properties: Optional[List[str]] = None,
    ):
        self._type = obj_type
        self._setup_working_dir(working_dir, config, version, scaling)
        if version is None:
            try:
                version = self.config["versions"][obj_type]
            except Exception:
                version = 0
        self._version = version
        self._n_folders_fs = n_folders_fs or 100
        self._numpy_cache: Dict[str, np.ndarray] = {}
        self._property_cache: Dict[str, dict] = {}
        if create:
            os.makedirs(self.so_storage_path, exist_ok=True)
        if cache_properties:
            self.enable_property_cache(cache_properties)

    # ------------------------------------------------------------ properties
    @property
    def type(self) -> str:
        return self._type

    @property
    def version(self):
        return self._version

    @property
    def n_folders_fs(self) -> int:
        return self._n_folders_fs

    @property
    def path(self) -> str:
        return os.path.join(str(self.working_dir), f"{self.type}s_{self.version}")

    @property
    def so_storage_path(self) -> str:
        return os.path.join(self.path, "so_storage")

    @property
    def so_dir_paths(self) -> List[str]:
        """All storage shard directories."""
        paths = []
        for ix in get_unique_subfold_ixs(self.n_folders_fs):
            paths.append(
                os.path.join(self.so_storage_path, subfold_from_ix(int(ix), self.n_folders_fs).strip("/"))
            )
        return paths

    def exists(self) -> bool:
        return os.path.isdir(self.so_storage_path)

    # ------------------------------------------------------------- np caches
    def load_numpy_data(self, attr: str, allow_nonexisting: bool = True) -> Optional[np.ndarray]:
        if attr in self._numpy_cache:
            return self._numpy_cache[attr]
        p = os.path.join(self.path, f"{attr}s.npy")
        if not os.path.isfile(p):
            if allow_nonexisting:
                return None
            raise FileNotFoundError(p)
        arr = np.load(p, allow_pickle=True)
        self._numpy_cache[attr] = arr
        return arr

    def save_numpy_data(self, attr: str, arr: np.ndarray):
        os.makedirs(self.path, exist_ok=True)
        np.save(os.path.join(self.path, f"{attr}s.npy"), arr)
        self._numpy_cache[attr] = arr

    @property
    def ids(self) -> np.ndarray:
        arr = self.load_numpy_data("id")
        return arr if arr is not None else np.zeros(0, np.uint64)

    @property
    def sizes(self) -> np.ndarray:
        return self.load_numpy_data("size")

    @property
    def rep_coords(self) -> np.ndarray:
        d = self.load_numpy_data("rep_coord")
        # empty datasets cache a flat (0,) array; keep the (N, 3) contract so
        # downstream broadcasting against scale vectors works
        return d.reshape(-1, 3) if d is not None else d

    @property
    def bounding_boxes(self) -> np.ndarray:
        d = self.load_numpy_data("bounding_box")
        return d.reshape(-1, 2, 3) if d is not None else d

    # --------------------------------------------------------- property cache
    def enable_property_cache(self, keys: Sequence[str]):
        """RAM cache: id -> value for selected attributes."""
        ids = self.ids
        for key in keys:
            vals = self.load_numpy_data(key)
            if vals is None:
                continue
            self._property_cache[key] = dict(zip(ids.tolist(), vals))

    # ---------------------------------------------------------------- objects
    def get_segmentation_object(self, obj_id, **kwargs) -> SegmentationObject:
        if isinstance(obj_id, (list, np.ndarray)):
            return [self.get_segmentation_object(o, **kwargs) for o in obj_id]
        so = SegmentationObject(obj_id, obj_type=self.type, dataset=self, **kwargs)
        for key, cache in self._property_cache.items():
            if obj_id in cache:
                so.attr_dict[key] = cache[obj_id]
        return so

    def iter_objects(self) -> Iterator[SegmentationObject]:
        for oid in self.ids:
            yield self.get_segmentation_object(int(oid))

    def __repr__(self):
        return (
            f"SegmentationDataset(type='{self.type}', version={self.version}, "
            f"wd={self.working_dir!r})"
        )
