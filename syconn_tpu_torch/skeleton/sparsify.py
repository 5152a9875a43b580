"""Skeleton post-processing: sparsification, stub pruning, merging
(counterpart of ``syconn_tpu/skeleton/sparsify.py``).

``skeleton_to_nx`` / ``nx_to_skeleton`` keep their names but build and read
the port's :class:`..proc.graphs.AdjacencyGraph`, which iterates as a
networkx graph does: which degree-2 nodes sparsification drops, which stubs
pruning removes and which pair stitching bridges depend on that order, so
the skeletons equal the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..proc.graphs import AdjacencyGraph

__all__ = [
    "skeleton_to_nx",
    "nx_to_skeleton",
    "sparsify_skeleton",
    "prune_stub_branches",
    "merge_skeletons",
]


def skeleton_to_nx(skel: Dict[str, np.ndarray]) -> AdjacencyGraph:
    """Skeleton dict -> graph: node i carries ``position`` and ``diameter``;
    edges in the skeleton's order."""
    g = AdjacencyGraph()
    nodes = np.asarray(skel["nodes"])
    diam = np.asarray(skel.get("diameters", np.zeros(len(nodes))))
    for i in range(len(nodes)):
        g.add_node(i, position=nodes[i], diameter=float(diam[i]) if i < len(diam) else 0.0)
    for a, b in np.asarray(skel["edges"]).reshape(-1, 2):
        g.add_edge(int(a), int(b))
    return g


def nx_to_skeleton(g: AdjacencyGraph) -> Dict[str, np.ndarray]:
    """Graph -> skeleton dict: nodes renumbered in node order."""
    nodes = list(g.nodes)
    remap = {n: i for i, n in enumerate(nodes)}
    pos = np.array([g.nodes[n]["position"] for n in nodes], np.float32).reshape(-1, 3)
    diam = np.array([g.nodes[n].get("diameter", 0.0) for n in nodes], np.float32)
    edges = np.array([[remap[a], remap[b]] for a, b in g.edges()], np.int64).reshape(-1, 2)
    return {"nodes": pos, "edges": edges, "diameters": diam}


def sparsify_skeleton(
    skel: Dict[str, np.ndarray],
    scale=(1.0, 1.0, 1.0),
    angle_thresh_deg: float = 135.0,
    max_dist_nm: float = 500.0,
    min_dist_nm: float = 50.0,
) -> Dict[str, np.ndarray]:
    """Remove degree-2 nodes that are nearly collinear with their neighbours
    or closer than ``min_dist_nm`` to one of them."""
    g = skeleton_to_nx(skel)
    scale = np.asarray(scale, np.float64)
    changed = True
    while changed:
        changed = False
        for n in list(g.nodes):
            if g.degree(n) != 2:
                continue
            a, b = list(g.neighbors(n))
            pa = np.asarray(g.nodes[a]["position"], np.float64) * scale
            pn = np.asarray(g.nodes[n]["position"], np.float64) * scale
            pb = np.asarray(g.nodes[b]["position"], np.float64) * scale
            v1 = pa - pn
            v2 = pb - pn
            n1, n2 = np.linalg.norm(v1), np.linalg.norm(v2)
            if n1 == 0 or n2 == 0:
                drop = True
            else:
                cosang = np.clip(np.dot(v1, v2) / (n1 * n2), -1, 1)
                ang = np.degrees(np.arccos(cosang))
                drop = (
                    (ang > angle_thresh_deg and max(n1, n2) < max_dist_nm)
                    or min(n1, n2) < min_dist_nm
                )
            if drop:
                g.add_edge(a, b)
                g.remove_node(n)
                changed = True
    return nx_to_skeleton(g)


def prune_stub_branches(
    skel: Dict[str, np.ndarray], scale=(1.0, 1.0, 1.0), len_thres_nm: float = 1000.0
) -> Dict[str, np.ndarray]:
    """Remove terminal branches shorter than ``len_thres_nm``."""
    g = skeleton_to_nx(skel)
    scale = np.asarray(scale, np.float64)
    changed = True
    while changed:
        changed = False
        for leaf in [n for n in g.nodes if g.degree(n) == 1]:
            # walk inward until a branch point
            path = [leaf]
            cur = leaf
            prev = None
            length = 0.0
            while True:
                nbrs = [x for x in g.neighbors(cur) if x != prev]
                if len(nbrs) != 1:
                    break
                nxt = nbrs[0]
                length += float(
                    np.linalg.norm(
                        (np.asarray(g.nodes[cur]["position"]) - np.asarray(g.nodes[nxt]["position"]))
                        * scale
                    )
                )
                if g.degree(nxt) > 2:
                    break
                path.append(nxt)
                prev, cur = cur, nxt
            if length < len_thres_nm and len(path) < g.number_of_nodes():
                g.remove_nodes_from(path)
                changed = True
    return nx_to_skeleton(g)


def merge_skeletons(
    skels: Sequence[Dict[str, np.ndarray]], scale=(1.0, 1.0, 1.0), stitch: bool = True
) -> Optional[Dict[str, np.ndarray]]:
    """Concatenate per-cube skeleton fragments of one cell and stitch the
    components by bridging closest node pairs (in nm)."""
    skels = [s for s in skels if s is not None and len(s["nodes"])]
    if not skels:
        return None
    nodes, edges, diam = [], [], []
    off = 0
    for s in skels:
        nodes.append(np.asarray(s["nodes"], np.float32).reshape(-1, 3))
        edges.append(np.asarray(s["edges"], np.int64).reshape(-1, 2) + off)
        d = np.asarray(s.get("diameters", np.zeros(len(s["nodes"]))), np.float32)
        diam.append(d)
        off += len(s["nodes"])
    merged = {
        "nodes": np.concatenate(nodes),
        "edges": np.concatenate(edges),
        "diameters": np.concatenate(diam),
    }
    if stitch:
        from ..proc.graphs import stitch_skel_nx

        g = skeleton_to_nx(merged)
        scale = np.asarray(scale, np.float64)
        for n in g.nodes:
            g.nodes[n]["position_vx"] = g.nodes[n]["position"]
            g.nodes[n]["position"] = np.asarray(g.nodes[n]["position"], np.float64) * scale
        g = stitch_skel_nx(g)
        for n in g.nodes:
            g.nodes[n]["position"] = g.nodes[n].pop("position_vx")
        merged = nx_to_skeleton(g)
    return merged
