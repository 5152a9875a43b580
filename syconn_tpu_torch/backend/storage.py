"""Typed persistent stores for per-object payloads (counterpart of
``syconn_tpu/backend/storage.py``, same file formats): ``AttributeDict``,
``CompressedStorage``, ``VoxelStorage`` (alias ``VoxelStorageL``,
``VoxelStorageClass``), ``VoxelStorageDyn``,
``VoxelStorageLazyLoading``, ``MeshStorage`` and ``SkeletonStorage``.
Payloads are ``(bytes, dtype, shape)`` tuples compressed as
:mod:`.base` describes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .base import StorageBase, compress_payload, decompress_payload


class AttributeDict(StorageBase):
    """Per-object attribute dictionaries (plain pickled values)."""

    def __getitem__(self, key):
        # auto-vivify like the reference: missing keys yield a fresh dict
        if key not in self._dc_intern:
            d = {}
            if not self.read_only:
                self._dc_intern[key] = d
            return d
        return self._dc_intern[key]

    def __setitem__(self, key, value):
        if self.read_only:
            raise RuntimeError(f"Store {self._path} is read-only.")
        self._dc_intern[key] = value

    def copy_intern(self) -> dict:
        return dict(self._dc_intern)

    def update(self, other):
        if isinstance(other, AttributeDict):
            other = other._dc_intern
        for k, v in other.items():
            self._dc_intern[k] = v


class CompressedStorage(StorageBase):
    """Compressed numpy arrays keyed by object ID."""

    def _encode(self, value: np.ndarray):
        return compress_payload(np.asarray(value))

    def _decode(self, payload):
        return decompress_payload(payload)


class VoxelStorage(StorageBase):
    """Explicit per-object voxel masks: lists of (binary mask, offset).

    An object may consist of several sub-masks (one per processed chunk);
    ``append`` adds another. ``__getitem__`` returns
    ``(list_of_masks, list_of_offsets)``.
    """

    def _encode(self, value):
        masks, offsets = value
        return (
            [compress_payload(np.asarray(m, dtype=np.uint8)) for m in masks],
            [np.asarray(o, dtype=np.int64).tolist() for o in offsets],
        )

    def _decode(self, payload):
        masks_c, offsets = payload
        masks = [decompress_payload(p).astype(bool) for p in masks_c]
        return masks, [np.array(o, dtype=np.int64) for o in offsets]

    def append(self, key, voxel_mask: np.ndarray, offset):
        if key in self._dc_intern:
            masks, offsets = self[key]
            masks.append(np.asarray(voxel_mask, dtype=bool))
            offsets.append(np.asarray(offset, dtype=np.int64))
            self[key] = (masks, offsets)
        else:
            self[key] = ([np.asarray(voxel_mask, dtype=bool)], [np.asarray(offset, dtype=np.int64)])

    def object_size(self, key) -> int:
        masks, _ = self[key]
        return int(sum(int(m.sum()) for m in masks))


# historical aliases, as in the reference
VoxelStorageL = VoxelStorage
VoxelStorageClass = VoxelStorage


class VoxelStorageDyn(StorageBase):
    """Lightweight voxel store: keeps only bounding boxes / sizes / rep
    coords and re-queries the segmentation volume on voxel access
    (reference: storage.py:208, ``get_voxelmask_offset`` :280).

    Per key the payload is a dict with keys ``bounding_boxes`` (list of
    (2, 3) int arrays), ``sizes`` (list of ints) and optional extra
    attributes (e.g. per-chunk synapse stats).
    """

    def __init__(self, inp_p, voxel_mode: bool = True, voxeldata_path: Optional[str] = None, **kw):
        super().__init__(inp_p, **kw)
        self.voxel_mode = voxel_mode
        meta = self._dc_intern.get("meta", {})
        if voxeldata_path is not None:
            meta["voxeldata_path"] = voxeldata_path
            self._dc_intern["meta"] = meta
        self._voxeldata_path = meta.get("voxeldata_path")
        self._kd = None

    # meta entry must not look like an object
    def keys(self):
        return [k for k in self._dc_intern.keys() if k != "meta"]

    def __len__(self):
        return len(self.keys())

    def __iter__(self):
        return iter(self.keys())

    def __contains__(self, key):
        return key != "meta" and key in self._dc_intern

    def increase_object_size(self, key, size: int):
        d = self._dc_intern.setdefault(key, {"bounding_boxes": [], "sizes": []})
        d["sizes"].append(int(size))

    def append_bounding_box(self, key, bb):
        d = self._dc_intern.setdefault(key, {"bounding_boxes": [], "sizes": []})
        d["bounding_boxes"].append(np.asarray(bb, dtype=np.int64))

    def set_object_attrs(self, key, **attrs):
        d = self._dc_intern.setdefault(key, {"bounding_boxes": [], "sizes": []})
        d.update(attrs)

    def get_object_attr(self, key, attr, default=None):
        return self._dc_intern.get(key, {}).get(attr, default)

    def object_size(self, key) -> int:
        return int(sum(self._dc_intern[key]["sizes"]))

    def object_bounding_boxes(self, key) -> List[np.ndarray]:
        return list(self._dc_intern[key]["bounding_boxes"])

    def object_bounding_box(self, key) -> np.ndarray:
        bbs = np.array(self._dc_intern[key]["bounding_boxes"], dtype=np.int64)
        return np.array([bbs[:, 0].min(axis=0), bbs[:, 1].max(axis=0)])

    def _get_kd(self):
        if self._kd is None:
            from ..handler.basics import kd_factory

            self._kd = kd_factory(self._voxeldata_path)
        return self._kd

    def get_voxelmask_offset(self, key, overlap: int = 0):
        """Load the object's binary mask from the segmentation volume."""
        bb = self.object_bounding_box(key)
        off = bb[0] - overlap
        size = bb[1] - bb[0] + 2 * overlap
        kd = self._get_kd()
        seg = kd.load_seg(offset=off, size=size)
        return seg == key, off

    def get_voxel_coords(self, key) -> np.ndarray:
        """Voxel coordinates (N, 3) of the object (global frame)."""
        mask, off = self.get_voxelmask_offset(key)
        coords = np.argwhere(mask)
        return coords + off[None]

    def get_voxeldata(self, key):
        return self.get_voxelmask_offset(key)


class VoxelStorageLazyLoading:
    """npz-backed per-object voxel coordinate lists
    (reference: storage.py:424). Keys are ints, stored as strings."""

    def __init__(self, path: str, overwrite: bool = False):
        self.path = path
        self._dc: Dict[str, np.ndarray] = {}
        self._npz = None
        if overwrite and os.path.isfile(path):
            os.remove(path)
        if os.path.isfile(path):
            self._npz = np.load(path, allow_pickle=False)

    def __contains__(self, key) -> bool:
        k = str(key)
        return k in self._dc or (self._npz is not None and k in self._npz.files)

    def __getitem__(self, key) -> np.ndarray:
        k = str(key)
        if k in self._dc:
            return self._dc[k]
        return self._npz[k]

    def __setitem__(self, key, value: np.ndarray):
        self._dc[str(key)] = np.asarray(value)

    def __len__(self) -> int:
        n = len(self._dc)
        if self._npz is not None:
            n += sum(1 for k in self._npz.files if k not in self._dc)
        return n

    def keys(self):
        ks = set(self._dc.keys())
        if self._npz is not None:
            ks |= set(self._npz.files)
        return [int(k) for k in ks]

    def __iter__(self):
        return iter(self.keys())

    def push(self):
        data = {}
        if self._npz is not None:
            for k in self._npz.files:
                data[k] = self._npz[k]
        data.update(self._dc)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + f".tmp{os.getpid()}.npz"
        np.savez_compressed(tmp, **data)
        os.replace(tmp, self.path)

    def close(self):
        if self._npz is not None:
            self._npz.close()
            self._npz = None


class MeshStorage(StorageBase):
    """Per-object triangle meshes: [indices, vertices, normals(, colors)]."""

    def _encode(self, value: Sequence[np.ndarray]):
        value = list(value)
        ind = np.asarray(value[0], dtype=np.int64)
        vert = np.asarray(value[1], dtype=np.float32)
        norm = np.asarray(value[2], dtype=np.float32) if len(value) > 2 else np.zeros((0,), np.float32)
        out = [compress_payload(ind), compress_payload(vert), compress_payload(norm)]
        if len(value) > 3:
            out.append(compress_payload(np.asarray(value[3])))
        return out

    def _decode(self, payload):
        return [decompress_payload(p) for p in payload]


class SkeletonStorage(StorageBase):
    """Per-object skeletons: dict with 'nodes' (N,3), 'edges' (M,2),
    'diameters' (N,) and optional per-node attribute arrays."""

    def _encode(self, value: dict):
        return {k: compress_payload(np.asarray(v)) for k, v in value.items()}

    def _decode(self, payload):
        return {k: decompress_payload(p) for k, p in payload.items()}
