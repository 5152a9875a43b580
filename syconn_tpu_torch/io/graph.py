"""Supervoxel-graph (RAG) IO: bz2-compressed pickled edge lists
(counterpart of ``syconn_tpu/io/graph.py``, without networkx).

A graph is the dict that :func:`save_svgraph` writes and the JAX package
writes too: ``{"edges": (M, 2) uint64, "nodes": (N,) uint64 or None}``;
``nodes`` lists isolated nodes as well. :func:`load_svgraph` reads that
dict or a bare (M, 2) edge array and returns the dict with ``nodes``
filled in (the edges' ids where the file has none). A pickled
``networkx.Graph`` is refused with a message: convert it to the dict first.
"""

from __future__ import annotations

import bz2
import pickle
from typing import Dict, Union

import numpy as np

__all__ = ["load_svgraph", "save_svgraph", "graph_from_edges"]


class _NoNetworkx(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "networkx":
            raise ValueError(
                "this supervoxel graph is a pickled networkx.Graph, which the port does not "
                "read; convert it to {'edges': np.array(list(g.edges()), np.uint64), "
                "'nodes': np.array(list(g.nodes()), np.uint64)} and save that")
        return super().find_class(module, name)


def graph_from_edges(edges, nodes=None) -> Dict[str, np.ndarray]:
    """The graph dict of an (M, 2) edge array and, optionally, extra nodes."""
    edges = np.asarray(edges, np.uint64).reshape(-1, 2)
    if nodes is None:
        nodes = np.unique(edges)
    return {"edges": edges, "nodes": np.asarray(nodes, np.uint64).reshape(-1)}


def load_svgraph(path: str) -> Dict[str, np.ndarray]:
    """Load a supervoxel graph, bz2-compressed (``.bz2``) or plain."""
    opener = bz2.open if path.endswith(".bz2") else open
    with opener(path, "rb") as f:
        obj = _NoNetworkx(f).load()
    if isinstance(obj, dict) and "edges" in obj:
        return graph_from_edges(obj["edges"], obj.get("nodes"))
    edges = np.asarray(obj)
    if edges.ndim == 2 and edges.shape[1] == 2:
        return graph_from_edges(edges)
    raise ValueError(f"Unrecognized graph format in {path}.")


def save_svgraph(g: Union[Dict[str, np.ndarray], np.ndarray], path: str):
    """Write a graph dict, or an (M, 2) edge array (then without nodes)."""
    opener = bz2.open if path.endswith(".bz2") else open
    if isinstance(g, dict):
        obj = {"edges": np.asarray(g["edges"], np.uint64).reshape(-1, 2),
               "nodes": np.asarray(g["nodes"], np.uint64)}
    else:
        obj = {"edges": np.asarray(g, np.uint64), "nodes": None}
    with opener(path, "wb") as f:
        pickle.dump(obj, f, protocol=4)
