"""Cell-level helpers of steps 7-9: labels at coordinates, compartment
votes, geodesic distance to the soma, spine-head volumes, the synapse sign
ratio and the mesh-based skeleton (counterpart of
``syconn_tpu/reps/super_segmentation_helper.py``, without networkx).

Skeleton graphs are the port's :class:`..proc.graphs.AdjacencyGraph`
(networkx's iteration order); geodesic distances come from
``scipy.sparse.csgraph.dijkstra``, and the minimum spanning tree of
:func:`create_sso_skeleton_fast` is Kruskal's over the graph's edges in
networkx's order with a stable sort, as ``networkx.minimum_spanning_tree``
picks among equal weights. The view-based helpers (``*_nocache``, and
``semseg2mesh`` where no labels are stored) are ``inference/views_infer.py``'s
functions.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
from scipy import ndimage, sparse, spatial
from scipy.sparse.csgraph import dijkstra

from ..inference.views_infer import (  # noqa: F401 (the JAX package's names)
    celltype_of_sso_views as celltype_of_sso_nocache,
    gliapred_sso_views as gliapred_sso_nocache,
    semseg_of_sso_views as semseg_of_sso_nocache,
    view_embedding_of_sso as view_embedding_of_sso_nocache,
)
from ..proc.graphs import AdjacencyGraph, create_graph_from_coords
from ..proc.skeleton import majorityvote_skeleton_property, map_myelin2coords  # noqa: F401
from ..skeleton.sparsify import (  # noqa: F401
    nx_to_skeleton,
    prune_stub_branches,
    skeleton_to_nx,
    sparsify_skeleton,
    sparsify_skeleton as sparsify_skeleton_fast,
)

__all__ = [
    "create_sso_skeleton_fast",
    "sparsify_skeleton_fast",
    "prune_stub_branches",
    "majorityvote_skeleton_property",
    "map_myelin2coords",
    "semseg2mesh",
    "semseg_for_coords",
    "axoness_for_coords",
    "extract_spinehead_volume",
    "syn_sign_ratio_celltype",
    "shortestpath2soma",
    "majority_vote_compartments",
    "celltype_of_sso_nocache",
    "view_embedding_of_sso_nocache",
    "semseg_of_sso_nocache",
    "gliapred_sso_nocache",
]

def _kruskal_mst(g: AdjacencyGraph) -> AdjacencyGraph:
    """``networkx.minimum_spanning_tree(g)``: edges sorted stably by
    ``weight`` in ``g.edges()`` order, taken where they join two trees; the
    tree holds ``g``'s nodes in order, then the taken edges in order."""
    edges = g.edges()
    order = sorted(range(len(edges)), key=lambda i: g._adj[edges[i][0]][edges[i][1]]["weight"])
    parent = {n: n for n in g.nodes}

    def find(n):
        while parent[n] != n:
            parent[n] = parent[parent[n]]
            n = parent[n]
        return n

    t = AdjacencyGraph()
    for n, attr in g.nodes.items():
        t.add_node(n, **attr)
    for i in order:
        u, v = edges[i]
        ru, rv = find(u), find(v)
        if ru != rv:
            t.add_edge(u, v, **g._adj[u][v])
            parent[ru] = rv
    return t


def create_sso_skeleton_fast(ssv, ds_factor_nm: float = 2000.0, save: bool = True):
    """Skeleton from the cell mesh where no volume skeleton exists: surface
    samples, their kNN graph, its minimum spanning tree, sparsified."""
    from .rep_helper import surface_samples

    mesh = ssv.load_mesh("sv")
    verts = np.asarray(mesh[1], np.float32).reshape(-1, 3)
    if len(verts) == 0:
        return None
    samples = surface_samples(verts, bin_sizes=(ds_factor_nm,) * 3, max_nb_samples=None)
    g = create_graph_from_coords(samples, max_dist_nm=ds_factor_nm * 3, force_single_cc=True)
    mst = _kruskal_mst(g)
    scale = np.asarray(ssv.scaling, np.float64)
    gg = AdjacencyGraph()
    for n in mst.nodes:
        gg.add_node(n, position=samples[n] / scale, diameter=float(ds_factor_nm / 10))
    for u, v in mst.edges():
        gg.add_edge(u, v)
    sk = sparsify_skeleton(nx_to_skeleton(gg), scale=scale)
    ssv.skeleton = sk
    if save:
        os.makedirs(ssv.ssv_dir, exist_ok=True)
        ssv.save_skeleton()
    return sk


def semseg2mesh(ssv, semseg_key: str, **kw):
    """Vertex labels of a semantic segmentation, stored under
    ``{semseg_key}_vertex_labels``; where none are stored, predicted from
    rendered views (``kw``: ``semseg_of_sso_views``'s, ``device`` among them)."""
    v = ssv.lookup_in_attribute_dict(f"{semseg_key}_vertex_labels")
    if v is not None:
        return v
    return semseg_of_sso_nocache(ssv, semseg_key=semseg_key, **kw)


def semseg_for_coords(
    ssv, coords_vx: np.ndarray, semseg_key: str = "axoness",
    k: int = 50, ignore_labels: Sequence[int] = (),
) -> np.ndarray:
    """Labels at voxel coordinates: majority of the k nearest labeled mesh
    vertices (else the nearest skeleton node's label)."""
    labels = ssv.lookup_in_attribute_dict(f"{semseg_key}_vertex_labels")
    mesh = ssv.load_mesh("sv")
    verts = np.asarray(mesh[1], np.float32).reshape(-1, 3)
    if labels is None or len(verts) == 0:
        if ssv.load_skeleton() and semseg_key in ssv.skeleton:
            scale = np.asarray(ssv.scaling, np.float64)
            nodes_nm = np.asarray(ssv.skeleton["nodes"], np.float64) * scale[None]
            tree = spatial.cKDTree(nodes_nm)
            q = np.asarray(coords_vx, np.float64) * scale[None]
            _, ixs = tree.query(q)
            return np.asarray(ssv.skeleton[semseg_key])[ixs]
        raise ValueError(f"No '{semseg_key}' labels available for cell {ssv.id}.")
    labels = np.asarray(labels)
    sel = ~np.isin(labels, list(ignore_labels)) if len(ignore_labels) else \
        np.ones(len(labels), bool)
    tree = spatial.cKDTree(verts[sel])
    lv = labels[sel]
    q = np.asarray(coords_vx, np.float64) * np.asarray(ssv.scaling, np.float64)[None]
    kq = min(k, int(sel.sum()))
    _, ixs = tree.query(q, k=kq)
    ixs = np.atleast_2d(ixs)
    n_cls = int(labels.max()) + 1
    return np.array(
        [np.bincount(lv[row].astype(np.int64), minlength=n_cls).argmax() for row in ixs],
        np.int64)


def axoness_for_coords(ssv, coords_vx, **kw):
    return semseg_for_coords(ssv, coords_vx, semseg_key="axoness", **kw)


def majority_vote_compartments(skel: dict, key: str = "axoness") -> np.ndarray:
    """Homogenize compartment labels within unbranched skeleton segments:
    the branch points split the skeleton, and each segment takes its most
    frequent label."""
    g = skeleton_to_nx(skel)
    labels = np.asarray(skel[key]).copy()
    g.remove_nodes_from([n for n in g.nodes if g.degree(n) > 2])
    for comp in g.connected_components():
        members = list(comp)
        labels[members] = np.bincount(labels[members].astype(np.int64)).argmax()
    return labels


def shortestpath2soma(ssv, coords_vx: np.ndarray, axoness_key: str = "axoness") -> np.ndarray:
    """Geodesic skeleton distance (nm) from each coordinate to the nearest
    soma-labeled node (label 2): the coordinate's distance to its nearest
    node plus that node's Dijkstra distance. inf where the cell has no soma
    label or the node cannot reach one."""
    if not ssv.load_skeleton():
        raise ValueError("No skeleton.")
    sk = ssv.skeleton
    scale = np.asarray(ssv.scaling, np.float64)
    nodes_nm = np.asarray(sk["nodes"], np.float64) * scale[None]
    soma_nodes = ([int(i) for i in np.flatnonzero(np.asarray(sk.get(axoness_key, [])) == 2)]
                  if axoness_key in sk else [])
    if not soma_nodes:
        return np.full(len(np.atleast_2d(coords_vx)), np.inf)
    n = len(nodes_nm)
    # one weight per undirected edge, as networkx holds it; explicit zeros
    # stay edges in a csr matrix built from its arrays
    weights: Dict[tuple, float] = {}
    for a, b in np.asarray(sk["edges"], np.int64).reshape(-1, 2):
        a, b = int(a), int(b)
        if a != b:
            weights[(min(a, b), max(a, b))] = float(np.linalg.norm(nodes_nm[a] - nodes_nm[b]))
    keys = sorted(weights)
    rows = np.array([k[0] for k in keys], np.int64)
    cols = np.array([k[1] for k in keys], np.int64)
    data = np.array([weights[k] for k in keys], np.float64)
    indptr = np.searchsorted(rows, np.arange(n + 1))
    graph = sparse.csr_matrix((data, cols, indptr), shape=(n, n))
    dists = dijkstra(graph, directed=False, indices=soma_nodes, min_only=True)
    tree = spatial.cKDTree(nodes_nm)
    q = np.atleast_2d(np.asarray(coords_vx, np.float64)) * scale[None]
    d_n, ixs = tree.query(q)
    return np.array([d_n[i] + dists[int(ixs[i])] for i in range(len(q))])


def extract_spinehead_volume(
    sso, ctx_vol: Sequence[int] = (200, 200, 100), stats: Optional[dict] = None
) -> Dict[int, float]:
    """Spine-head volumes per spine-head synapse via a watershed on the cell
    segmentation.

    For every synapse of the cell whose location is predicted spine head
    (spiness == 1) on a dendrite (axoness == 0): load the segmentation cube
    ``2*ctx_vol`` around the synapse, mask it to the cell's supervoxels,
    fill holes, seed a distance-transform watershed at the distance maxima
    (each seed labeled by its k nearest spiness-labeled mesh vertices), keep
    the head basins (label 1), refine them by the vertex vote, and count
    the voxels of the inscribed ball at the distance peak nearest the
    synapse. Volumes are stored in ``sso.attr_dict['spinehead_vol']`` (µm³,
    keyed by syn_ssv ID) — call ``sso.save_attr_dict()`` to persist.
    ``stats`` (optional dict) receives the count of qualifying synapses.
    """
    from ..handler.basics import kd_factory
    from ..ops.cc import watershed_distance
    from ..ops.contacts import relabel_vol_nonexist2zero
    from ..proc.image import in_bounding_box
    from .rep_helper import colorcode_vertices

    if len(sso.attr_dict) == 0:
        sso.load_attr_dict()
    sso.attr_dict["spinehead_vol"] = {}
    ctx_vol = np.asarray(ctx_vol, np.int64)
    scaling = np.asarray(sso.scaling, np.float64)
    cfg_sp = sso.config["spines"]["semseg2coords_spines"]

    labels = sso.lookup_in_attribute_dict("spiness_vertex_labels")
    mesh = sso.load_mesh("sv")
    verts_nm = np.asarray(mesh[1], np.float64).reshape(-1, 3)
    if labels is None or len(verts_nm) == 0:
        raise ValueError(f"'spiness' vertex labels not available for cell {sso.id}.")
    sp_semseg = np.asarray(labels).reshape(-1)
    verts = verts_nm / scaling[None]  # voxel coords
    for lab in cfg_sp.get("ignore_labels", []):
        verts = verts[sp_semseg != lab]
        sp_semseg = sp_semseg[sp_semseg != lab]

    syns = sso.syn_ssv
    if len(syns) == 0:
        return {}
    syn_coords = np.array([s.rep_coord for s in syns], np.int64)
    syn_ids = np.array([s.id for s in syns], np.uint64)
    # spine-head synapses on dendrites only
    curr_sp = semseg_for_coords(
        sso, syn_coords, "spiness", k=int(cfg_sp.get("k", 50)),
        ignore_labels=cfg_sp.get("ignore_labels", []))
    try:
        curr_ax = semseg_for_coords(sso, syn_coords, "axoness")
    except ValueError:
        curr_ax = np.zeros(len(syn_coords), np.int64)
    sel = (curr_sp == 1) & (curr_ax == 0)
    syn_coords = syn_coords[sel]
    syn_ids = syn_ids[sel]
    if stats is not None:
        stats["qualifying"] = int(len(syn_ids))
    if len(syn_coords) == 0:
        return {}

    kd = kd_factory(sso.config.kd_seg_path)
    sv_ids = sso.sv_ids
    k_nn = int(cfg_sp.get("k", 50))
    vox_nm3 = float(np.prod(scaling))
    out: Dict[int, float] = {}
    for c, syn_id in zip(syn_coords, syn_ids):
        offset = np.maximum(c - ctx_vol, 0)
        # the cube is cut one voxel beyond the dataset: the zeros further out
        # change no distance, hole, maximum or label of the voxels inside, and
        # near a border of a small dataset they are most of the cube
        size = np.minimum(2 * ctx_vol, kd.boundary - offset + 1).astype(np.int64)
        seg = kd.load_seg(offset=offset, size=size, mag=1)
        if len(sv_ids) > 1:
            seg = relabel_vol_nonexist2zero(seg.astype(np.uint64), {int(k): 1 for k in sv_ids})
        else:
            seg = (seg == sv_ids[0]).astype(np.int32)
        mask = ndimage.binary_fill_holes(seg > 0)
        if not mask.any():
            continue
        # labeled vertices inside the cube
        vsel = in_bounding_box(verts, np.array([offset + size / 2, size]))
        verts_bb = verts[vsel]
        semseg_bb = sp_semseg[vsel].copy()
        if len(semseg_bb) == 0:
            continue
        semseg_bb[semseg_bb == 0] = 9  # spine neck stays distinct from head
        # anisotropic EDT in nm at native mag 1
        dist = ndimage.distance_transform_edt(mask, sampling=scaling)
        # local maxima of the distance transform as watershed seeds
        maxf = ndimage.maximum_filter(dist, size=3)
        maxima = np.argwhere((dist >= maxf) & mask & (dist > 0))
        if len(maxima) == 0:
            continue
        maxima_sp = colorcode_vertices(
            maxima, verts_bb - offset[None], semseg_bb,
            k=min(k_nn, len(verts_bb)), return_color=False)
        markers = np.zeros(mask.shape, np.int32)
        markers[maxima[:, 0], maxima[:, 1], maxima[:, 2]] = maxima_sp
        basins = watershed_distance(mask, markers, sampling=scaling)
        head = basins == 1
        lab, nb = ndimage.label(head)
        if nb == 0:
            continue
        cl = c - offset
        max_id = 1
        if nb > 1:
            sl = tuple(slice(max(int(cl[i]) - 10, 0), int(cl[i]) + 11) for i in range(3))
            ids, cnts = np.unique(lab[sl], return_counts=True)
            cnts = cnts[ids != 0]
            ids = ids[ids != 0]
            if len(ids) == 0:
                # nearest head component to the synapse
                coords_all = np.argwhere(lab > 0)
                d = np.linalg.norm((coords_all - cl[None]) * scaling[None], axis=1)
                max_id = int(lab[tuple(coords_all[np.argmin(d)])])
            else:
                max_id = int(ids[np.argmax(cnts)])
        comp = np.argwhere(lab == max_id)
        # keep the basin voxels whose nearest labeled vertices vote head,
        # then the connected piece at/nearest the synapse
        vox_lab = colorcode_vertices(
            comp, verts_bb - offset[None], semseg_bb,
            k=min(k_nn, len(verts_bb)), return_color=False)
        head_sel = vox_lab == 1
        if head_sel.any():
            refined = np.zeros(mask.shape, bool)
            refined[tuple(comp[head_sel].T)] = True
            rlab, rnb = ndimage.label(refined)
            if rnb > 1:
                rcoords = np.argwhere(rlab > 0)
                d = np.linalg.norm((rcoords - cl[None]) * scaling[None], axis=1)
                keep = int(rlab[tuple(rcoords[np.argmin(d)])])
                keep_vox = rcoords[np.asarray(rlab[tuple(rcoords.T)]) == keep]
            else:
                keep_vox = comp[head_sel]
        else:
            keep_vox = comp
        # inscribed-ball cap at the distance peak nearest the synapse
        in_keep = np.zeros(mask.shape, bool)
        in_keep[tuple(keep_vox.T)] = True
        cand = maxima[in_keep[tuple(maxima.T)]]
        if len(cand) == 0:
            d_edt = dist[tuple(keep_vox.T)]
            cand = keep_vox[d_edt >= d_edt.max() - 0.5 * float(scaling.min())]
        m_star = cand[np.argmin(np.linalg.norm((cand - cl[None]) * scaling[None], axis=1))]
        # the EDT at a digitized ball's center under-reads the radius by
        # about half the in-plane pitch
        r_h = float(dist[tuple(m_star)]) + 0.5 * float(scaling.min())
        d_ball = np.linalg.norm((keep_vox - m_star[None]) * scaling[None], axis=1)
        n_vox = int((d_ball <= r_h).sum())
        out[int(syn_id)] = n_vox * vox_nm3 / 1e9  # µm³
    sso.attr_dict["spinehead_vol"] = out
    return out


def syn_sign_ratio_celltype(ssv, weighted: bool = True) -> float:
    """Fraction of symmetric (inhibitory) synapses of a cell, optionally
    size-weighted; nan without synapses."""
    from .segmentation import SegmentationDataset

    ssv.load_attr_dict()
    syn_ids = np.asarray(ssv.attr_dict.get("syn_ssv", []), np.uint64)
    if len(syn_ids) == 0:
        return float("nan")
    sd = SegmentationDataset("syn_ssv", working_dir=ssv.working_dir, config=ssv.config)
    sel = np.isin(sd.ids, syn_ids)
    signs = np.asarray(sd.load_numpy_data("syn_sign"))[sel]
    sizes = np.asarray(sd.sizes)[sel].astype(np.float64)
    w = sizes if weighted else np.ones_like(sizes)
    return float(np.sum((signs < 0) * w) / np.sum(w))
