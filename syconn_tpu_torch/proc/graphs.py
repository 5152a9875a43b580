"""Graph operations on supervoxel graphs and skeletons (counterpart of
``syconn_tpu/proc/graphs.py``, without networkx).

Supervoxel graphs are the ``{"edges", "nodes"}`` dicts of :mod:`..io.graph`;
their connected components come from ``scipy.sparse.csgraph``, and every
result that leaves this module is order-free (sorted lists, sets, sizes).

Skeleton graphs are :class:`AdjacencyGraph`: the JAX package's skeleton
post-processing walks networkx graphs, and what it keeps (sparsified nodes,
pruned stubs, the edge picked to stitch two components among equal
distances) depends on networkx's iteration order: nodes in insertion
order, neighbours in edge-insertion order, ``edges()`` as networkx emits
them, and components as the Python sets its BFS builds. The class keeps
networkx's dict-of-dicts layout, so every one of those orders is the same.

The subgraph windows (``split_subcc``, ``split_subcc_join``,
``chunkify_graph_bfs``) walk :class:`AdjacencyGraph` in the order of
``networkx.bfs_tree``; nothing in either package calls them or
``bfs_smoothing``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

import numpy as np
from scipy import spatial
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

__all__ = ["AdjacencyGraph", "create_ccsize_dict", "graph_components", "induced_subgraph",
           "graph_nodes", "remove_glia_nodes", "split_glia_graph", "create_graph_from_coords",
           "stitch_skel_nx", "bfs_order", "split_subcc", "split_subcc_join", "bfs_smoothing",
           "chunkify_graph_bfs"]


class AdjacencyGraph:
    """An undirected graph laid out as ``networkx.Graph`` is (``_node``:
    node -> attribute dict, ``_adj``: node -> neighbour -> edge attribute
    dict, all insertion-ordered), with the methods the skeleton code uses,
    each iterating in networkx's order."""

    def __init__(self):
        self._node: Dict[int, dict] = {}
        self._adj: Dict[int, Dict[int, dict]] = {}

    def add_node(self, n, **attr):
        if n not in self._node:
            self._adj[n] = {}
            self._node[n] = attr
        else:
            self._node[n].update(attr)

    def add_edge(self, u, v, **attr):
        for n in (u, v):
            if n not in self._node:
                self._adj[n] = {}
                self._node[n] = {}
        dd = self._adj[u].get(v, {})
        dd.update(attr)
        self._adj[u][v] = dd
        self._adj[v][u] = dd

    def remove_node(self, n):
        nbrs = list(self._adj[n])
        del self._node[n]
        for u in nbrs:
            del self._adj[u][n]
        del self._adj[n]

    def remove_nodes_from(self, nodes: Iterable):
        for n in nodes:
            if n in self._node:
                self.remove_node(n)

    @property
    def nodes(self) -> Dict[int, dict]:
        """Node -> attribute dict; iterating it gives the nodes in order."""
        return self._node

    def neighbors(self, n) -> Iterator:
        return iter(self._adj[n])

    def degree(self, n) -> int:
        return len(self._adj[n]) + (1 if n in self._adj[n] else 0)

    def number_of_nodes(self) -> int:
        return len(self._node)

    def edges(self) -> List[Tuple]:
        """Each edge once, as ``networkx.Graph.edges()`` lists them."""
        out, seen = [], set()
        for n, nbrs in self._adj.items():
            for nbr in nbrs:
                if nbr not in seen:
                    out.append((n, nbr))
            seen.add(n)
        return out

    def connected_components(self) -> Iterator[Set]:
        """``networkx.connected_components``: components in node order, each
        the Python set its BFS fills (so ``list(c)`` has networkx's order)."""
        seen: Set = set()
        for v in self._node:
            if v in seen:
                continue
            c = {v}
            level = [v]
            while level:
                nxt = []
                for u in level:
                    for w in self._adj[u]:
                        if w not in c:
                            c.add(w)
                            nxt.append(w)
                level = nxt
            seen.update(c)
            yield c

    def is_connected(self) -> bool:
        return len(self._node) > 0 and sum(1 for _ in self.connected_components()) == 1

    def subgraph(self, nodes: Iterable) -> "AdjacencyGraph":
        """``networkx.Graph.subgraph(nodes).copy()``, orders included: the
        view walks the Python set of ``nodes`` when that set is less than
        half the graph, else the graph's node order; each node's neighbours
        stay in insertion order."""
        keep = set(n for n in nodes if n in self._node)
        if 2 * len(keep) < len(self._node):
            order = [n for n in keep if n in self._node]
        else:
            order = [n for n in self._node if n in keep]
        out = AdjacencyGraph()
        for n in order:
            out.add_node(n, **self._node[n])
        for u in order:
            for v, dd in self._adj[u].items():
                if v in keep:
                    out.add_edge(u, v, **dd)
        return out


def graph_nodes(g: Dict[str, np.ndarray]) -> np.ndarray:
    """A graph dict's sorted unique nodes, those of its edges included."""
    edges = np.asarray(g["edges"], np.uint64).reshape(-1, 2)
    return np.unique(np.concatenate([np.asarray(g["nodes"], np.uint64).reshape(-1),
                                     edges.reshape(-1)]))


def induced_subgraph(g: Dict[str, np.ndarray], nodes) -> Dict[str, np.ndarray]:
    """The graph dict on ``nodes`` with every edge of ``g`` between two of
    them (``networkx.Graph.subgraph(nodes).copy()``; nodes sorted)."""
    nodes = np.unique(np.asarray(list(nodes), np.uint64).reshape(-1))
    edges = np.asarray(g["edges"], np.uint64).reshape(-1, 2)
    keep = np.isin(edges[:, 0], nodes) & np.isin(edges[:, 1], nodes)
    return {"edges": edges[keep], "nodes": nodes}


def graph_components(g: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """``(nodes, labels)``: the graph's sorted unique node ids (those of the
    edges included) and each one's connected-component label."""
    edges = np.asarray(g["edges"], np.uint64).reshape(-1, 2)
    nodes = graph_nodes(g)
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


def component_lists(g: Dict[str, np.ndarray]) -> List[List[int]]:
    """The connected components of a graph dict, each a sorted list of
    ints, in the order of their smallest member."""
    nodes, labels = graph_components(g)
    order = np.argsort(labels, kind="stable")
    splits = np.flatnonzero(np.diff(labels[order])) + 1
    comps = [sorted(int(n) for n in m) for m in np.split(nodes[order], splits) if len(m)]
    return sorted(comps)


# ------------------------------------------------------------ glia splitting
def remove_glia_nodes(
    g: Dict[str, np.ndarray], glia_probas: Dict[int, float], glia_thresh: float,
    min_cc_size_nm: float, bbs: Optional[Dict[int, np.ndarray]] = None,
) -> Tuple[List[int], List[int]]:
    """Partition a cell's SV graph into neuron and astrocyte nodes by
    thresholding per-SV glia probability; components smaller than
    ``min_cc_size_nm`` (bounding-box diagonal) flip to the other side, the
    neuron side first. Returns (neuron_nodes, glia_nodes), sorted."""
    nodes = [int(n) for n in graph_nodes(g)]
    glia_nodes = {n for n in nodes if glia_probas.get(n, 0.0) > glia_thresh}
    neuron_nodes = set(nodes) - glia_nodes
    if bbs is not None and min_cc_size_nm > 0:
        for side_nodes, other in ((neuron_nodes, glia_nodes), (glia_nodes, neuron_nodes)):
            sub = induced_subgraph(g, side_nodes)
            ccsize = create_ccsize_dict(sub, bbs) if len(side_nodes) else {}
            flip = {n for n in side_nodes if ccsize.get(n, 0) < min_cc_size_nm}
            side_nodes -= flip
            other |= flip
    return sorted(neuron_nodes), sorted(glia_nodes)


def split_glia_graph(g, glia_probas, glia_thresh, min_cc_size_nm, bbs=None):
    """The neuron and astrocyte subgraphs of :func:`remove_glia_nodes`."""
    neuron, glia = remove_glia_nodes(g, glia_probas, glia_thresh, min_cc_size_nm, bbs)
    return induced_subgraph(g, neuron), induced_subgraph(g, glia)


# ------------------------------------------------------------ skeleton graphs
def create_graph_from_coords(
    coords: np.ndarray, max_dist_nm: float = 6000, force_single_cc: bool = True, k: int = 3
) -> AdjacencyGraph:
    """kNN graph over coordinates (edge attribute ``weight``); optionally
    one connected component, by bridging the closest pairs."""
    coords = np.asarray(coords, np.float64)
    g = AdjacencyGraph()
    for i in range(len(coords)):
        g.add_node(i)
    if len(coords) <= 1:
        return g
    tree = spatial.cKDTree(coords)
    dists, ixs = tree.query(coords, k=min(k + 1, len(coords)))
    for i in range(len(coords)):
        for j_ix in range(1, ixs.shape[1]):
            j = ixs[i, j_ix]
            if dists[i, j_ix] <= max_dist_nm:
                g.add_edge(i, int(j), weight=float(dists[i, j_ix]))
    if force_single_cc:
        comps = [list(c) for c in g.connected_components()]
        while len(comps) > 1:
            base = comps[0]
            base_tree = spatial.cKDTree(coords[base])
            best = (np.inf, None, None)
            for other in comps[1:]:
                d, ix = base_tree.query(coords[other])
                m = int(np.argmin(d))
                if d[m] < best[0]:
                    best = (float(d[m]), other[m], base[int(ix[m])])
            g.add_edge(best[1], best[2], weight=best[0])
            comps = [list(c) for c in g.connected_components()]
    return g


def stitch_skel_nx(skel_nx: AdjacencyGraph) -> AdjacencyGraph:
    """Connect all components of a skeleton graph by repeatedly bridging the
    closest node pair between the first component and any other (node
    attribute ``position`` holds the coordinates; the first pair found among
    equal distances wins, as in the JAX package)."""
    comps = [list(c) for c in skel_nx.connected_components()]
    if len(comps) <= 1:
        return skel_nx
    pos = {n: d["position"] for n, d in skel_nx.nodes.items() if "position" in d}
    while len(comps) > 1:
        base = comps[0]
        base_coords = np.array([pos[n] for n in base], np.float64)
        tree = spatial.cKDTree(base_coords)
        best = (np.inf, None, None)
        for other in comps[1:]:
            oc = np.array([pos[n] for n in other], np.float64)
            d, ix = tree.query(oc)
            m = int(np.argmin(d))
            if d[m] < best[0]:
                best = (float(d[m]), other[m], base[int(ix[m])])
        skel_nx.add_edge(best[1], best[2])
        comps = [list(c) for c in skel_nx.connected_components()]
    return skel_nx


# ------------------------------------------------------------ subgraph windows
def bfs_order(g: AdjacencyGraph, source) -> List:
    """The nodes of ``networkx.bfs_tree(g, source)`` in its iteration order:
    the source, then every node as the breadth-first search first reaches
    it, level by level, each node's neighbours in adjacency order."""
    order, seen, level = [source], {source}, [source]
    while level:
        nxt = []
        for u in level:
            for w in g._adj[u]:
                if w not in seen:
                    seen.add(w)
                    nxt.append(w)
        order.extend(nxt)
        level = nxt
    return order


def split_subcc(g: AdjacencyGraph, max_nb: int, verbose: bool = False,
                start_nodes=None) -> Dict:
    """Partition a graph into BFS-grown subgraphs of <= ``max_nb`` nodes,
    seeded in node order (or ``start_nodes``). Returns {seed node: [nodes]}."""
    out = {}
    visited = set()
    nodes = start_nodes if start_nodes is not None else list(g.nodes)
    for seed in nodes:
        if seed in visited:
            continue
        members = []
        for n in bfs_order(g, seed):
            if n in visited:
                continue
            members.append(n)
            visited.add(n)
            if len(members) >= max_nb:
                break
        out[seed] = members
    return out


def split_subcc_join(g: AdjacencyGraph, subgraph_size: int, lo_first_n: int = 1) -> List[List]:
    """Overlapping BFS windows over each connected component: windows of
    ``subgraph_size`` nodes, each starting ``lo_first_n`` nodes after the one
    before, from the component's first node in networkx's set order."""
    out = []
    for comp in g.connected_components():
        order = bfs_order(g, next(iter(comp)))
        i = 0
        while i < len(order):
            window = order[max(0, i): i + subgraph_size]
            if not window:
                break
            out.append(list(window))
            if i + subgraph_size >= len(order):
                break
            i += max(1, lo_first_n)
    return out


def bfs_smoothing(vertices: np.ndarray, vertex_labels: np.ndarray, n_voting: int = 40,
                  max_edge_length: float = 250) -> np.ndarray:
    """Majority-smooth vertex labels over each vertex's ``n_voting`` nearest
    neighbours within ``max_edge_length`` (ties to the smaller label)."""
    tree = spatial.cKDTree(vertices)
    _, ixs = tree.query(vertices, k=min(n_voting, len(vertices)),
                        distance_upper_bound=max_edge_length)
    labels = np.asarray(vertex_labels)
    out = labels.copy()
    valid_max = len(vertices)
    for i in range(len(vertices)):
        neigh = ixs[i]
        neigh = neigh[neigh < valid_max]
        out[i] = np.bincount(labels[neigh].astype(np.int64)).argmax()
    return out


def chunkify_graph_bfs(g: AdjacencyGraph, n_chunks: int) -> List[List]:
    """The nodes in BFS order per connected component, cut into lists of
    ``len(nodes) // n_chunks`` (at least 1)."""
    nodes = []
    for comp in g.connected_components():
        nodes.extend(bfs_order(g, next(iter(comp))))
    size = max(1, len(nodes) // max(n_chunks, 1))
    return [nodes[i: i + size] for i in range(0, len(nodes), size)]
