"""Mesh processing: per-chunk object meshing, merging, export (counterpart
of ``syconn_tpu/proc/meshes.py``, the same numpy code): ``find_meshes``
(surface nets per object of a label chunk), ``merge_meshes``,
``mesh_area_calc``, ``write_mesh2kzip``, ``triangulation_from_coords``
(meshes of the cell-level synapses and contacts, step 6),
``compartmentalize_mesh`` (a cell mesh split by its vertex labels, step 7)
and the view helpers ``calc_rot_matrices`` (per-location PCA rotations of
the view boxes) and ``MeshObject``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy import ndimage

from ..mesh.surface_nets import mesh_area, simplify_mesh, surface_net_mesh

__all__ = [
    "find_meshes",
    "merge_meshes",
    "merge_someshes",
    "mesh_area_calc",
    "get_object_mesh",
    "write_mesh2kzip",
    "triangulation_from_coords",
    "calc_rot_matrices",
    "MeshObject",
    "compartmentalize_mesh",
]


def find_meshes(
    chunk: np.ndarray,
    offset,
    scale,
    downsampling=(1, 1, 1),
    simplify_nm: float = 0.0,
    obj_ids: Optional[Sequence[int]] = None,
) -> Dict[int, List[np.ndarray]]:
    """Mesh every object in a label chunk.

    Returns {id: [ind, vert, norm]} with vertices in nm (global frame).
    """
    chunk = np.asarray(chunk)
    offset = np.asarray(offset, np.int64)
    out: Dict[int, List[np.ndarray]] = {}
    # remap arbitrary (possibly 64-bit) IDs to a compact range first —
    # find_objects allocates max_id slots
    uniq, inv = np.unique(chunk, return_inverse=True)
    compact = inv.reshape(chunk.shape).astype(np.int64)
    if uniq[0] != 0:
        compact += 1
        uniq = np.concatenate([[0], uniq])
    slices = ndimage.find_objects(compact)
    present = uniq[uniq != 0]
    if obj_ids is not None:
        present = np.intersect1d(present, np.asarray(obj_ids))
    lut = {int(u): k for k, u in enumerate(uniq)}
    for oid in present:
        cix = lut[int(oid)]
        sl = slices[cix - 1] if cix - 1 < len(slices) else None
        if sl is None:
            continue
        sub = compact[sl] == cix
        sub_off = offset + np.array([s.start for s in sl])
        ind, vert, norm = surface_net_mesh(
            sub, offset=sub_off, scale=scale, downsample=downsampling
        )
        if simplify_nm > 0 and len(vert):
            ind, vert = simplify_mesh(ind, vert, simplify_nm)
            norm = np.zeros(0, np.float32)
        out[int(oid)] = [ind, vert, norm]
    return out


def merge_meshes(meshes: Sequence[Sequence[np.ndarray]]) -> List[np.ndarray]:
    """Concatenate flat (ind, vert[, norm]) meshes with index offsets."""
    all_ind, all_vert, all_norm = [], [], []
    v_off = 0
    for m in meshes:
        ind = np.asarray(m[0]).reshape(-1)
        vert = np.asarray(m[1]).reshape(-1)
        if len(ind) == 0:
            continue
        all_ind.append(ind.astype(np.int64) + v_off)
        all_vert.append(vert.astype(np.float32))
        if len(m) > 2 and m[2] is not None and len(np.asarray(m[2])):
            all_norm.append(np.asarray(m[2]).reshape(-1).astype(np.float32))
        v_off += len(vert) // 3
    if not all_ind:
        return [np.zeros(0, np.int64), np.zeros(0, np.float32), np.zeros(0, np.float32)]
    norm = np.concatenate(all_norm) if (all_norm and sum(len(v) for v in all_vert) == sum(len(n) for n in all_norm)) else np.zeros(0, np.float32)
    return [np.concatenate(all_ind), np.concatenate(all_vert), norm]


def merge_someshes(sos, **kw) -> List[np.ndarray]:
    """Merge the meshes of several segmentation objects."""
    return merge_meshes([so.mesh for so in sos if so.mesh is not None])


def mesh_area_calc(mesh) -> float:
    """Surface area in µm²."""
    return mesh_area(np.asarray(mesh[0]), np.asarray(mesh[1]))


def get_object_mesh(so, downsampling=None, **kw):
    """The object's mesh computed anew from its voxels
    (reference: proc/meshes.py:1029)."""
    return so.mesh_from_scratch(downsampling=downsampling)


def triangulation_from_coords(
    coords_nm: np.ndarray, voxel_size_nm: float = 20.0, offset=None, depth: int = 0
) -> List[np.ndarray]:
    """Mesh a point cloud by voxelizing at ``voxel_size_nm`` + surface nets
    (the cs_ssv / syn_ssv meshes): watertight and deterministic."""
    coords = np.asarray(coords_nm, np.float64)
    if len(coords) == 0:
        return [np.zeros(0, np.int32), np.zeros(0, np.float32), np.zeros(0, np.float32)]
    lo = coords.min(axis=0) - voxel_size_nm
    q = np.floor((coords - lo) / voxel_size_nm).astype(np.int64)
    sh = q.max(axis=0) + 2
    mask = np.zeros(tuple(sh), bool)
    mask[q[:, 0], q[:, 1], q[:, 2]] = True
    # close single-voxel gaps
    mask = ndimage.binary_closing(mask, structure=np.ones((3, 3, 3), bool))
    ind, vert, norm = surface_net_mesh(mask, scale=(voxel_size_nm,) * 3)
    vert = vert.reshape(-1, 3) + lo[None].astype(np.float32)
    return [ind, vert.reshape(-1), norm]


def calc_rot_matrices(coords: np.ndarray, vertices: np.ndarray, edge_length_nm: float) -> np.ndarray:
    """Per-location PCA rotation matrices for view rendering: orient each
    view box along the local principal axes of the surrounding vertex cloud."""
    from scipy import spatial

    coords = np.asarray(coords, np.float32)
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    tree = spatial.cKDTree(vertices)
    rots = np.zeros((len(coords), 3, 3), np.float32)
    for i, c in enumerate(coords):
        ixs = tree.query_ball_point(c, edge_length_nm)
        if len(ixs) < 3:
            rots[i] = np.eye(3)
            continue
        pts = vertices[ixs] - c[None]
        cov = pts.T @ pts / len(pts)
        _, evecs = np.linalg.eigh(cov)
        rot = evecs[:, ::-1].T  # rows = principal axes, major first
        if np.linalg.det(rot) < 0:
            rot[2] *= -1
        rots[i] = rot
    return rots


class MeshObject:
    """Normalized-coordinate mesh wrapper."""

    def __init__(self, object_type: str, indices, vertices, normals=None, color=None, swap_yz=False):
        self.object_type = object_type
        self.indices = np.asarray(indices, np.int64).reshape(-1)
        vert = np.asarray(vertices, np.float32).reshape(-1, 3)
        self._raw_vertices = vert
        self.center = vert.mean(axis=0) if len(vert) else np.zeros(3, np.float32)
        extent = (vert.max(axis=0) - vert.min(axis=0)).max() if len(vert) else 1.0
        self.max_dist = max(float(extent) / 2.0, 1e-6)
        self.vertices = ((vert - self.center) / self.max_dist).reshape(-1)
        self.normals = (
            np.asarray(normals, np.float32).reshape(-1) if normals is not None else np.zeros(0, np.float32)
        )
        self.color = color

    @property
    def vert_resh(self) -> np.ndarray:
        return self.vertices.reshape(-1, 3)

    def transform_external_coords(self, coords: np.ndarray) -> np.ndarray:
        return (np.asarray(coords, np.float32) - self.center[None]) / self.max_dist

    def retransform_external_coords(self, coords: np.ndarray) -> np.ndarray:
        return np.asarray(coords, np.float32) * self.max_dist + self.center[None]


def compartmentalize_mesh(ssv, semseg_key: str = "axoness") -> Dict[int, List[np.ndarray]]:
    """Split a cell mesh into per-compartment sub-meshes by vertex labels.
    Triangles vote by majority of their three vertices."""
    labels = ssv.lookup_in_attribute_dict(f"{semseg_key}_vertex_labels")
    if labels is None:
        raise ValueError(f"Cell {ssv.id} has no '{semseg_key}' vertex labels.")
    labels = np.asarray(labels)
    mesh = ssv.load_mesh("sv")
    f = np.asarray(mesh[0], np.int64).reshape(-1, 3)
    v = np.asarray(mesh[1], np.float32).reshape(-1, 3)
    tri_labels = np.median(labels[f], axis=1).astype(np.int64)
    out: Dict[int, List[np.ndarray]] = {}
    for lab in np.unique(tri_labels):
        sel = f[tri_labels == lab]
        used, inv = np.unique(sel.reshape(-1), return_inverse=True)
        out[int(lab)] = [
            inv.astype(np.int64),
            v[used].reshape(-1),
            np.zeros(0, np.float32),
        ]
    return out


def write_mesh2kzip(kzip_path: str, ind, vert, norm, color, ply_fname: str):
    """Write a mesh into a kzip archive as PLY."""
    from ..handler.basics import write_txt2kzip

    ply = _make_ply(ind, vert, norm, color)
    write_txt2kzip(kzip_path, ply, ply_fname)


def _make_ply(ind, vert, norm, color=None) -> bytes:
    v = np.asarray(vert, np.float32).reshape(-1, 3)
    f = np.asarray(ind, np.int64).reshape(-1, 3)
    lines = [
        b"ply",
        b"format ascii 1.0",
        f"element vertex {len(v)}".encode(),
        b"property float x",
        b"property float y",
        b"property float z",
        f"element face {len(f)}".encode(),
        b"property list uchar int vertex_indices",
        b"end_header",
    ]
    for p in v:
        lines.append(f"{p[0]} {p[1]} {p[2]}".encode())
    for t in f:
        lines.append(f"3 {t[0]} {t[1]} {t[2]}".encode())
    return b"\n".join(lines) + b"\n"
