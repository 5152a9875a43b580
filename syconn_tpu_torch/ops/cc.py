"""Connected components, seeded watershed and cross-chunk label merging
(counterpart of ``syconn_tpu/ops/cc.py``; numpy and scipy).

Intra-chunk labeling (scipy, or :mod:`.cc_torch` on a torch device),
globally unique label encoding by chunk index, face-pair extraction, and a
numpy union-find for the global merge.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

__all__ = [
    "connected_components",
    "watershed_from_seeds",
    "watershed_distance",
    "encode_chunk_labels",
    "face_merge_pairs",
    "UnionFind",
    "merge_pairs_to_map",
]

# labels are encoded chunk_linear_index * 2**24 + local_label
CHUNK_LABEL_STRIDE = np.uint64(1 << 24)


def connected_components(mask: np.ndarray, device=False) -> Tuple[np.ndarray, int]:
    """6-connected components of a binary mask; labels 1..n in
    first-occurrence order (scipy semantics), as uint32, and n.

    ``device``: False runs scipy on the host; anything else names the torch
    device of :func:`.cc_torch.connected_components_torch` (None: the CUDA
    card, which must exist). The caller chooses; no error switches sides.
    """
    if device is not False:
        from .cc_torch import connected_components_torch

        return connected_components_torch(mask, device=device)
    lab, n = ndimage.label(np.asarray(mask), structure=ndimage.generate_binary_structure(3, 1))
    return lab.astype(np.uint32), int(n)


def watershed_from_seeds(mask: np.ndarray, seeds: np.ndarray) -> np.ndarray:
    """Flood labeled seeds through a binary mask (6-connected BFS).

    Equivalent to a geodesic nearest-seed assignment — the reference uses a
    watershed on the pre-erosion mask with seeds from the eroded mask's
    components (object_extraction_steps.py:204-260, config
    ``extract_morph_op`` trailing erosions).

    Frontier-based multi-source BFS: each sweep only touches the current
    frontier's neighbors (O(N) total work) instead of the former full-volume
    grey-dilation fixpoint (O(N * diameter)). Equal-distance ties go to the
    smallest seed label (deterministic).
    """
    mask = np.asarray(mask).astype(bool)
    out = np.where(mask, seeds, 0).astype(np.uint32)
    _bfs_flood(mask.reshape(-1), out.reshape(-1), mask.shape)
    return out


def _bfs_flood(
    flat_mask: np.ndarray,
    flat_out: np.ndarray,
    shape,
    frontier: Optional[np.ndarray] = None,
) -> None:
    """In place: expand the nonzero labels of ``flat_out`` into unlabeled
    ``flat_mask`` voxels by 6-connected multi-source BFS (frontier sweeps;
    smallest label wins equal-distance ties). ``frontier`` optionally
    restricts the initial sources (must be labeled voxel indices)."""
    sx, sy, sz = shape
    syz = sy * sz
    if frontier is None:
        frontier = np.flatnonzero(flat_out)
    while frontier.size:
        labels = flat_out[frontier]
        cx = frontier // syz
        rem = frontier - cx * syz
        cy = rem // sz
        cz = rem - cy * sz
        nxt_ix = []
        nxt_lb = []
        for coord, size, stride in ((cx, sx, syz), (cy, sy, sz), (cz, sz, 1)):
            for sgn in (1, -1):
                ok = (coord + sgn < size) if sgn > 0 else (coord > 0)
                ni = frontier[ok] + sgn * stride
                sel = flat_mask[ni] & (flat_out[ni] == 0)
                nxt_ix.append(ni[sel])
                nxt_lb.append(labels[ok][sel])
        ni = np.concatenate(nxt_ix)
        if ni.size == 0:
            break
        nl = np.concatenate(nxt_lb)
        # a voxel reached from several seeds this sweep: smallest label wins
        order = np.lexsort((nl, ni))
        ni, nl = ni[order], nl[order]
        first = np.ones(len(ni), bool)
        first[1:] = ni[1:] != ni[:-1]
        ni, nl = ni[first], nl[first]
        flat_out[ni] = nl
        frontier = ni


def watershed_distance(
    mask: np.ndarray,
    markers: np.ndarray,
    sampling: Optional[Sequence[float]] = None,
    levels: int = 64,
) -> np.ndarray:
    """Distance-transform watershed of a binary mask with labeled markers
    (the reference's ``skimage.segmentation.watershed(-distance, markers,
    mask=mask)`` pattern, super_segmentation_helper.py:2171).

    Meyer-style flooding discretized to ``levels`` buckets: the inverted
    Euclidean distance transform (optionally anisotropic via ``sampling``)
    is quantized, and basins grow level by level — at each level the
    current labels BFS-flood into newly *active* voxels (cost <= level), so
    plateaus are split by geodesic proximity rather than the arbitrary
    tie-breaking of a max-arc IFT.
    """
    mask = np.asarray(mask).astype(bool)
    markers = np.asarray(markers)
    out = np.where(mask, markers, 0).astype(np.uint32)
    if not out.any():
        return out
    dist = ndimage.distance_transform_edt(mask, sampling=sampling)
    dmax = float(dist.max())
    if dmax <= 0:
        return out
    # cost level 0 = deepest basin interior (largest distance)
    q = np.zeros(mask.shape, np.int32)
    q[mask] = np.ceil((dmax - dist[mask]) / dmax * levels).astype(np.int32)
    shape = mask.shape
    sx, sy, sz = shape
    syz = sy * sz
    flat_out = out.reshape(-1)
    flat_q = q.reshape(-1)
    flat_mask = mask.reshape(-1)
    # bucket mask voxels by level once
    mask_ix = np.flatnonzero(flat_mask)
    order = np.argsort(flat_q[mask_ix], kind="stable")
    sorted_ix = mask_ix[order]
    bounds = np.searchsorted(flat_q[sorted_ix], np.arange(levels + 2))
    active = np.zeros(flat_mask.shape, bool)

    def _labeled_neighbors(ixs: np.ndarray) -> np.ndarray:
        """Labeled voxels 6-adjacent to ``ixs`` (BFS sources for a level)."""
        cx = ixs // syz
        rem = ixs - cx * syz
        cy = rem // sz
        cz = rem - cy * sz
        srcs = []
        for coord, size, stride in ((cx, sx, syz), (cy, sy, sz), (cz, sz, 1)):
            for sgn in (1, -1):
                ok = (coord + sgn < size) if sgn > 0 else (coord > 0)
                ni = ixs[ok] + sgn * stride
                srcs.append(ni[flat_out[ni] != 0])
        return np.unique(np.concatenate(srcs)) if srcs else np.zeros(0, np.int64)

    for lv in range(levels + 1):
        newly = sorted_ix[bounds[lv] : bounds[lv + 1]]
        if newly.size == 0:
            continue
        active[newly] = True
        sources = _labeled_neighbors(newly)
        # marker voxels activating at this level are sources themselves
        marked = newly[flat_out[newly] != 0]
        if marked.size:
            sources = np.unique(np.concatenate([sources, marked]))
        if sources.size:
            _bfs_flood(active, flat_out, shape, frontier=sources)
    # stragglers (active but never reached, e.g. around late markers)
    if (flat_mask & (flat_out == 0)).any():
        _bfs_flood(flat_mask, flat_out, shape)
    return out


def encode_chunk_labels(local_labels: np.ndarray, chunk_index: int) -> np.ndarray:
    """Offset chunk-local labels into a globally unique uint64 space
    (reference: make_unique_labels — here a deterministic chunk stride,
    assuming < 2**24 objects per chunk)."""
    lab = local_labels.astype(np.uint64)
    out = np.where(
        lab != 0, lab + np.uint64(chunk_index) * CHUNK_LABEL_STRIDE, np.uint64(0)
    )
    return out


def face_merge_pairs(face_a: np.ndarray, face_b: np.ndarray) -> np.ndarray:
    """Label pairs to merge across a chunk face: voxels where both adjacent
    labels are nonzero (6-connectivity across the face). Returns (N, 2)."""
    a = np.asarray(face_a).reshape(-1)
    b = np.asarray(face_b).reshape(-1)
    sel = (a != 0) & (b != 0)
    if not sel.any():
        return np.zeros((0, 2), dtype=np.uint64)
    pairs = np.stack([a[sel], b[sel]], axis=1).astype(np.uint64)
    return np.unique(pairs, axis=0)


class UnionFind:
    """Array-based union-find over arbitrary uint64 keys."""

    def __init__(self, keys: np.ndarray):
        self.keys = np.unique(np.asarray(keys, dtype=np.uint64))
        self.parent = np.arange(len(self.keys), dtype=np.int64)

    def _ix(self, ks: np.ndarray) -> np.ndarray:
        ix = np.searchsorted(self.keys, ks)
        if len(self.keys) == 0 or not np.all(self.keys[np.clip(ix, 0, len(self.keys) - 1)] == ks):
            raise KeyError("unknown keys in union-find")
        return ix

    def find(self, i: int) -> int:
        root = i
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[i] != root:  # path compression
            self.parent[i], i = root, self.parent[i]
        return root

    def union_pairs(self, pairs: np.ndarray):
        if len(pairs) == 0:
            return
        ia = self._ix(pairs[:, 0].astype(np.uint64))
        ib = self._ix(pairs[:, 1].astype(np.uint64))
        for a, b in zip(ia, ib):
            ra, rb = self.find(int(a)), self.find(int(b))
            if ra != rb:
                self.parent[max(ra, rb)] = min(ra, rb)

    def root_keys(self) -> np.ndarray:
        roots = np.array([self.find(i) for i in range(len(self.keys))], dtype=np.int64)
        return self.keys[roots]


def merge_pairs_to_map(
    all_labels: np.ndarray, pairs: np.ndarray, compact: bool = True
) -> Dict[int, int]:
    """Global merge map: every encoded label -> final object ID.

    With ``compact`` the final IDs are 1..K in ascending root order
    (deterministic across runs).
    """
    uf = UnionFind(all_labels)
    uf.union_pairs(pairs)
    roots = uf.root_keys()
    if compact:
        uniq_roots = np.unique(roots)
        remap = {int(r): i + 1 for i, r in enumerate(uniq_roots)}
        return {int(k): remap[int(r)] for k, r in zip(uf.keys, roots)}
    return {int(k): int(r) for k, r in zip(uf.keys, roots)}
