"""Mesh processing: per-chunk object meshing, merging, export (counterpart
of ``syconn_tpu/proc/meshes.py``, the same numpy code): ``find_meshes``
(surface nets per object of a label chunk), ``merge_meshes``,
``mesh_area_calc`` and ``write_mesh2kzip``. The view
and cell-level helpers come with the steps that use them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy import ndimage

from ..mesh.surface_nets import mesh_area, simplify_mesh, surface_net_mesh

__all__ = [
    "find_meshes",
    "merge_meshes",
    "mesh_area_calc",
    "write_mesh2kzip",
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


def mesh_area_calc(mesh) -> float:
    """Surface area in µm²."""
    return mesh_area(np.asarray(mesh[0]), np.asarray(mesh[1]))


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
