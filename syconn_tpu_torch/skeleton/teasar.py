"""TEASAR skeletonization of label volumes (counterpart of
``syconn_tpu/skeleton/teasar.py``).

1. distance-to-boundary field (DBF) via an anisotropic EDT;
2. a penalty field that makes shortest paths hug the centerline:
   ``p(v) = K * (1 - DBF(v)/max)^16``;
3. one Dijkstra pass from the root (the geodesically farthest voxel from an
   arbitrary start) yields distances + predecessors;
4. repeatedly take the farthest unvisited voxel, walk its predecessor path
   until it meets the existing tree, append the branch, and invalidate all
   voxels within ``scale * DBF + const`` of the new path nodes.

The grid version in C++ (``ops/csrc/teasar.cpp``, built by
``utils/native.py``) runs whenever the host library builds and its node
capacity suffices; the Python version below is the fallback, as in the JAX
package. ``ROUTES`` counts the objects each route skeletonized, so a run
can tell that the host library was used.

Output: nodes (voxel coords), edges, diameters (2 x DBF in nm at the nodes).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
from scipy import ndimage, sparse
from scipy.sparse.csgraph import dijkstra

__all__ = ["teasar_skeleton", "skeletonize_object", "skeletonize_volume", "ROUTES",
           "reset_routes"]

ROUTES = {"native": 0, "python": 0}
_routes_lock = threading.Lock()


def reset_routes():
    with _routes_lock:
        for k in ROUTES:
            ROUTES[k] = 0


def _count(route: str):
    with _routes_lock:
        ROUTES[route] += 1

_PENALTY_K = 5000.0
_PENALTY_EXP = 16


def _build_graph(mask: np.ndarray, scale: np.ndarray, penalty: np.ndarray):
    """26-neighborhood weighted graph over mask voxels (csr)."""
    idx_vol = -np.ones(mask.shape, np.int64)
    coords = np.argwhere(mask)
    n = len(coords)
    idx_vol[mask] = np.arange(n)
    rows, cols, data = [], [], []
    pen_flat = penalty[mask]
    offsets = [
        (dx, dy, dz)
        for dx in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dz in (-1, 0, 1)
        if (dx, dy, dz) > (0, 0, 0)  # each undirected edge once
    ]
    for off in offsets:
        dist = float(np.linalg.norm(np.asarray(off) * scale))
        src_sl = tuple(slice(max(0, -o), mask.shape[d] - max(0, o)) for d, o in enumerate(off))
        dst_sl = tuple(slice(max(0, o), mask.shape[d] + min(0, o)) for d, o in enumerate(off))
        a = idx_vol[src_sl]
        b = idx_vol[dst_sl]
        sel = (a >= 0) & (b >= 0)
        ai = a[sel]
        bi = b[sel]
        w = dist + 0.5 * (pen_flat[ai] + pen_flat[bi])
        rows.append(ai)
        cols.append(bi)
        data.append(w)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    data = np.concatenate(data).astype(np.float32)
    g = sparse.csr_matrix(
        (np.concatenate([data, data]), (np.concatenate([rows, cols]), np.concatenate([cols, rows]))),
        shape=(n, n),
    )
    return g, coords


def _teasar_native(mask, dbf, scale, inval_const, inval_scale, max_paths):
    """Grid TEASAR in C++ (``ops/csrc/teasar.cpp``: no materialized CSR
    graph, the dominant cost of the Python path). Returns None when the host
    library is unavailable or capacities overflow (the caller falls back to
    the Python implementation)."""
    from ..utils.native import get_native

    lib = get_native()
    if lib is None or not hasattr(lib, "teasar_grid"):
        return None
    m = np.ascontiguousarray(mask, np.uint8)
    d = np.ascontiguousarray(dbf, np.float32)
    node_cap = int(min(mask.size, 2_000_000))
    edge_cap = node_cap
    nodes = np.empty((node_cap, 3), np.int32)
    edges = np.empty((edge_cap, 2), np.int32)
    diam = np.empty(node_cap, np.float32)
    n_nodes = np.zeros(1, np.int64)
    n_edges = np.zeros(1, np.int64)
    rc = lib.teasar_grid(
        m, m.shape[0], m.shape[1], m.shape[2], d,
        np.ascontiguousarray(scale, np.float64),
        float(_PENALTY_K), int(_PENALTY_EXP),
        float(inval_const), float(inval_scale), int(max_paths),
        nodes.reshape(-1), node_cap, edges.reshape(-1), edge_cap, diam,
        n_nodes, n_edges,
    )
    if rc != 0:
        return None
    k, e = int(n_nodes[0]), int(n_edges[0])
    return {
        "nodes": nodes[:k].astype(np.float32),
        "edges": edges[:e].astype(np.int64).reshape(-1, 2),
        "diameters": diam[:k].copy(),
    }


def teasar_skeleton(
    mask: np.ndarray,
    scale=(1.0, 1.0, 1.0),
    invalidation_const_nm: float = 150.0,
    invalidation_scale: float = 3.0,
    max_paths: int = 512,
) -> Optional[Dict[str, np.ndarray]]:
    """Skeletonize one connected binary object.

    Returns dict(nodes (N,3) voxel coords, edges (M,2), diameters (N,) nm)
    or None for degenerate inputs.
    """
    mask = np.asarray(mask).astype(bool)
    scale = np.asarray(scale, np.float64)
    n_vox = int(mask.sum())
    if n_vox == 0:
        return None
    if n_vox == 1:
        c = np.argwhere(mask)[0]
        return {
            "nodes": c[None].astype(np.float32),
            "edges": np.zeros((0, 2), np.int64),
            "diameters": np.array([float(scale.min())], np.float32),
        }
    dbf = ndimage.distance_transform_edt(mask, sampling=scale)
    native = _teasar_native(
        mask, dbf, scale, invalidation_const_nm, invalidation_scale, max_paths
    )
    if native is not None:
        _count("native")
        return native
    _count("python")
    m = float(dbf.max())
    penalty = _PENALTY_K * (1.0 - dbf / (1.01 * m)) ** _PENALTY_EXP
    g, coords = _build_graph(mask, scale, penalty)
    n = len(coords)

    # root: farthest voxel (geodesic) from an arbitrary start
    d0 = dijkstra(g, indices=0, return_predecessors=False)
    finite = np.isfinite(d0)
    root = int(np.argmax(np.where(finite, d0, -1)))
    dist, pred = dijkstra(g, indices=root, return_predecessors=True)
    reachable = np.isfinite(dist)

    dbf_flat = dbf[mask]
    coords_nm = coords * scale[None]
    visited = ~reachable  # unreachable voxels are ignored
    on_tree = np.zeros(n, bool)
    on_tree[root] = True
    node_ids = {root: 0}
    nodes = [root]
    edges = []

    from scipy import spatial as _spatial

    kdt = _spatial.cKDTree(coords_nm)
    for _ in range(max_paths):
        cand = np.where(~visited)[0]
        if len(cand) == 0:
            break
        target = int(cand[np.argmax(dist[cand])])
        # walk predecessors until we hit the tree
        path = []
        v = target
        while v != -9999 and not on_tree[v]:
            path.append(v)
            v = int(pred[v])
        if v == -9999:
            visited[target] = True
            continue
        anchor = v
        path = path[::-1]  # from tree outward
        prev = anchor
        for p in path:
            if p not in node_ids:
                node_ids[p] = len(nodes)
                nodes.append(p)
            edges.append((node_ids[prev], node_ids[p]))
            on_tree[p] = True
            prev = p
        # rolling-ball invalidation around the new branch
        radii = invalidation_const_nm + invalidation_scale * dbf_flat[path]
        for p, r in zip(path, radii):
            for q in kdt.query_ball_point(coords_nm[p], float(r)):
                visited[q] = True
        visited[target] = True

    nodes_arr = coords[nodes].astype(np.float32)
    return {
        "nodes": nodes_arr,
        "edges": np.asarray(edges, np.int64).reshape(-1, 2),
        "diameters": (2.0 * dbf_flat[nodes]).astype(np.float32),
    }


def skeletonize_object(
    mask: np.ndarray,
    offset=(0, 0, 0),
    scale=(1.0, 1.0, 1.0),
    downsample: int = 1,
    **kw,
) -> Optional[Dict[str, np.ndarray]]:
    """Skeletonize possibly-multi-component object masks; components are
    skeletonized independently (merged later by the cube stitcher)."""
    mask = np.asarray(mask).astype(bool)
    if downsample > 1:
        mask = mask[::downsample, ::downsample, ::downsample]
        scale = np.asarray(scale, np.float64) * downsample
    lab, n_cc = ndimage.label(mask, structure=np.ones((3, 3, 3), bool))
    slices = ndimage.find_objects(lab)
    parts = []
    for c in range(1, n_cc + 1):
        sl = slices[c - 1]
        if sl is None:
            continue
        # crop to the component's bounding box: EDT/Dijkstra/invalidation
        # cost scales with the box, not the cube
        sub = lab[sl] == c
        sk = teasar_skeleton(sub, scale=scale, **kw)
        if sk is not None and len(sk["nodes"]):
            sk["nodes"] = sk["nodes"] + np.array(
                [s.start for s in sl], np.float32
            )[None]
            parts.append(sk)
    if not parts:
        return None
    # merge components into one node table (no cross-edges)
    nodes, edges, diam = [], [], []
    off = 0
    for sk in parts:
        nodes.append(sk["nodes"])
        edges.append(sk["edges"] + off)
        diam.append(sk["diameters"])
        off += len(sk["nodes"])
    out_nodes = np.concatenate(nodes) * downsample + np.asarray(offset, np.float32)[None]
    return {
        "nodes": out_nodes,
        "edges": np.concatenate(edges),
        "diameters": np.concatenate(diam),
    }


def skeletonize_volume(
    seg: np.ndarray,
    offset=(0, 0, 0),
    scale=(1.0, 1.0, 1.0),
    dust_threshold_vx: int = 0,
    downsample: int = 1,
    obj_ids=None,
    **kw,
) -> Dict[int, Dict[str, np.ndarray]]:
    """Skeletonize every label in a volume; returns {id: skeleton}."""
    seg = np.asarray(seg)
    # compact relabel + C find_objects: per-id bounding boxes without a
    # sort-based property scan (ids here are few SSVs per cube)
    uniq = np.unique(seg)
    compact = np.searchsorted(uniq, seg).astype(np.int32)
    counts = np.bincount(compact.ravel(), minlength=len(uniq))
    if uniq[0] != 0:  # find_objects treats label 0 as background
        compact += 1
    lab0 = 1 if uniq[0] != 0 else 0
    slices = ndimage.find_objects(compact)
    out = {}
    offset = np.asarray(offset, np.int64)
    for k, oid in enumerate(uniq):
        if oid == 0 or counts[k] < dust_threshold_vx:
            continue
        if obj_ids is not None and int(oid) not in obj_ids:
            continue
        sl = slices[k + lab0 - 1]
        if sl is None:
            continue
        # bounding-box crop: the == scan and all downstream work run on the
        # object's extent, not the whole cube
        sk = skeletonize_object(
            seg[sl] == oid,
            offset=offset + np.array([s.start for s in sl], np.int64),
            scale=scale,
            downsample=downsample,
            **kw,
        )
        if sk is not None:
            out[int(oid)] = sk
    return out
