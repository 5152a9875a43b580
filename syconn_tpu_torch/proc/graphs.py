"""Graph operations on supervoxel graphs (counterpart of
``syconn_tpu/proc/graphs.py``, without networkx). Graphs are the
``{"edges", "nodes"}`` dicts of :mod:`..io.graph`; connected components
come from ``scipy.sparse.csgraph``. The other functions of the JAX module
(subgraph windows, skeleton stitching, glia splitting) come with the steps
that use them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

__all__ = ["create_ccsize_dict", "graph_components"]


def graph_components(g: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """``(nodes, labels)``: the graph's sorted unique node ids (those of the
    edges included) and each one's connected-component label."""
    edges = np.asarray(g["edges"], np.uint64).reshape(-1, 2)
    nodes = np.unique(np.concatenate([np.asarray(g["nodes"], np.uint64).reshape(-1),
                                      edges.reshape(-1)]))
    ix = np.searchsorted(nodes, edges)
    n = len(nodes)
    adj = coo_matrix((np.ones(len(ix), np.int8), (ix[:, 0], ix[:, 1])), shape=(n, n))
    _, labels = connected_components(adj, directed=False)
    return nodes, labels


def create_ccsize_dict(g: Dict[str, np.ndarray], bbs: Dict[int, np.ndarray],
                       is_connected_components: bool = False) -> Dict[int, float]:
    """Per-node size of its connected component, measured as the bounding-box
    diagonal (nm) of the union of the members' boxes. ``is_connected_components``:
    the whole graph is one component."""
    nodes, labels = graph_components(g)
    if is_connected_components:
        labels = np.zeros_like(labels)
    out: Dict[int, float] = {}
    order = np.argsort(labels, kind="stable")
    splits = np.flatnonzero(np.diff(labels[order])) + 1
    for members in np.split(nodes[order], splits):
        boxes = np.array([bbs[int(n)] for n in members if int(n) in bbs])
        if len(boxes) == 0:
            diag = 0.0
        else:
            diag = float(np.linalg.norm(boxes[:, 1].max(axis=0) - boxes[:, 0].min(axis=0)))
        for n in members:
            out[int(n)] = diag
    return out
