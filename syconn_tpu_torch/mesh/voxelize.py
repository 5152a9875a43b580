"""Triangle-mesh voxelization: surface sampling and solidification
(counterpart of ``syconn_tpu/mesh/voxelize.py``).

The inverse of meshing: a cell mesh (vertices in nm) back into a bool
volume at ``scale`` nm per voxel, axes (x, y, z). The surface samples come
from ``np.random.default_rng(seed)`` exactly as in the JAX package, so both
give the same volume for the same mesh.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["sample_mesh_surface", "voxelize_mesh"]


def sample_mesh_surface(ind: np.ndarray, vert_nm: np.ndarray, max_spacing_nm: float,
                        seed: int = 0) -> np.ndarray:
    """Area-weighted random points (nm) on a triangle mesh: at least
    area / max_spacing_nm^2 per triangle, and every vertex, so that thin
    or small triangles are never missed."""
    tri = np.asarray(ind, np.int64).reshape(-1, 3)
    v = np.asarray(vert_nm, np.float64).reshape(-1, 3)
    a, b, c = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    n_per = np.maximum(1, np.ceil(areas / max(max_spacing_nm, 1e-6) ** 2)).astype(np.int64)
    rng = np.random.default_rng(seed)
    t_ix = np.repeat(np.arange(len(tri)), n_per)
    r1 = np.sqrt(rng.random(len(t_ix)))
    r2 = rng.random(len(t_ix))
    pts = ((1.0 - r1)[:, None] * a[t_ix] + (r1 * (1.0 - r2))[:, None] * b[t_ix]
           + (r1 * r2)[:, None] * c[t_ix])
    return np.concatenate([pts, v], axis=0)


def _fill2d(shell: np.ndarray, axis: int) -> np.ndarray:
    from scipy import ndimage

    out = np.zeros_like(shell)
    for i in range(shell.shape[axis]):
        sl = [slice(None)] * 3
        sl[axis] = i
        out[tuple(sl)] = ndimage.binary_fill_holes(shell[tuple(sl)])
    return out


def voxelize_mesh(ind: np.ndarray, vert_nm: np.ndarray, scale: Sequence[float],
                  offset_nm: Sequence[float], shape: Sequence[int], solid: bool = True,
                  seed: int = 0) -> np.ndarray:
    """Rasterize a mesh into a bool volume of ``shape`` voxels.

    ``scale``: nm per voxel (x, y, z); ``offset_nm``: the world position of
    voxel (0, 0, 0). Samples at half the voxel pitch mark the shell; with
    ``solid`` the interior is filled by 2D hole filling along each axis (a
    tube cut open at the crop boundary still closes in one orientation) and
    a 3D cavity fill."""
    scale = np.asarray(scale, np.float64)
    offset_nm = np.asarray(offset_nm, np.float64)
    shape = tuple(int(s) for s in shape)
    # only the triangles that reach the crop box (+1 voxel margin) are
    # sampled: sampling the whole mesh for a small window is O(total area)
    tri = np.asarray(ind, np.int64).reshape(-1, 3)
    v = np.asarray(vert_nm, np.float64).reshape(-1, 3)
    lo = offset_nm - scale
    hi = offset_nm + (np.asarray(shape) + 1) * scale
    tv = v[tri]  # (T, 3, 3)
    keep_tri = np.all(tv.max(axis=1) >= lo[None], axis=1) & np.all(
        tv.min(axis=1) <= hi[None], axis=1)
    tri = tri[keep_tri]
    if len(tri) == 0:
        return np.zeros(shape, bool)
    used = np.unique(tri.reshape(-1))
    remap = np.zeros(len(v), np.int64)
    remap[used] = np.arange(len(used))
    pts = sample_mesh_surface(remap[tri], v[used], max_spacing_nm=float(scale.min()) / 2.0,
                              seed=seed)
    ijk = np.floor((pts - offset_nm[None]) / scale[None]).astype(np.int64)
    keep = np.all((ijk >= 0) & (ijk < np.asarray(shape)[None]), axis=1)
    ijk = ijk[keep]
    vol = np.zeros(shape, bool)
    vol[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = True
    if not solid or not vol.any():
        return vol
    from scipy import ndimage

    shell = ndimage.binary_closing(vol, structure=np.ones((3, 3, 3), bool))
    filled = shell | _fill2d(shell, 0) | _fill2d(shell, 1) | _fill2d(shell, 2)
    return ndimage.binary_fill_holes(filled)
