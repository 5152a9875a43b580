"""The port's skeleton code against the JAX package on the CPU, exactly
(arrays equal in order, not only in canonical form):

* TEASAR (``skeleton/teasar.py``) on seeded label volumes, through the C++
  host kernel of both packages and through the Python fallback of both;
* sparsification, stub pruning, fragment merging with stitching, and the
  sliding-window majority vote on grid skeletons with exact distance ties,
  whose results depend on networkx's iteration order;
* ``AdjacencyGraph`` iterating as ``networkx.Graph`` does (nodes, neighbours,
  edges, components) under random edits;
* the BFS subgraph windows (``split_subcc``, ``split_subcc_join``,
  ``chunkify_graph_bfs``) on seeded graphs of many equal-depth branches, and
  ``bfs_smoothing`` on grid vertices with tied distances and tied votes.
"""

import random

import numpy as np
import pytest

nx = pytest.importorskip("networkx")


def _same_skel(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _label_volume(seed, shape=(48, 40, 24)):
    """Blobby objects and a branching tube, ids > 2**32 in part."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    seg = np.zeros(shape, np.uint64)
    for k, oid in enumerate((5, 2 ** 33 + 1, 77)):
        noise = ndimage.gaussian_filter(rng.random(shape), 3)
        seg[(noise > np.quantile(noise, 0.93)) & (seg == 0)] = oid
    seg[4:44, 18:22, 10:14] = 9
    seg[22:26, 4:36, 10:14] = 9
    return seg


@pytest.mark.parametrize("route", ["native", "python"])
def test_teasar_equals_jax(monkeypatch, route):
    import syconn_tpu.utils.native as jnative
    from syconn_tpu.skeleton import teasar as jteasar
    from syconn_tpu_torch.skeleton import teasar
    import syconn_tpu_torch.utils.native as tnative

    if route == "python":
        monkeypatch.setattr(jnative, "get_native", lambda: None)
        monkeypatch.setattr(tnative, "get_native", lambda: None)
    else:
        assert tnative.get_native() is not None, "g++ builds the host library here"
    seg = _label_volume(1)
    teasar.reset_routes()
    kw = dict(offset=(3, 5, 7), scale=(10.0, 10.0, 20.0), dust_threshold_vx=20)
    for ds in (1, 2):
        ref = jteasar.skeletonize_volume(seg, downsample=ds, **kw)
        got = teasar.skeletonize_volume(seg, downsample=ds, **kw)
        assert sorted(got) == sorted(ref) and len(got) >= 3
        for oid in ref:
            _same_skel(got[oid], ref[oid])
    assert teasar.ROUTES[route] > 0 and teasar.ROUTES[
        "python" if route == "native" else "native"] == 0, teasar.ROUTES
    mask = seg == 9
    _same_skel(teasar.teasar_skeleton(mask, scale=(10, 10, 20)),
               jteasar.teasar_skeleton(mask, scale=(10, 10, 20)))


def _grid_skeleton(seed, n=120):
    """A random tree on grid positions (many equal distances), with stubs
    and near-collinear runs."""
    rng = np.random.default_rng(seed)
    nodes = [np.zeros(3)]
    edges = []
    steps = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [2, 0, 0], [0, 3, 0]], float)
    for i in range(1, n):
        parent = int(rng.integers(max(0, i - 6), i))
        nodes.append(nodes[parent] + steps[rng.integers(0, len(steps))] * rng.integers(1, 4))
        edges.append((parent, i))
    nodes = np.asarray(nodes, np.float32)
    return {"nodes": nodes, "edges": np.asarray(edges, np.int64),
            "diameters": rng.random(n).astype(np.float32) * 100}


@pytest.mark.parametrize("seed", range(4))
def test_sparsify_prune_merge_equal_jax(seed):
    from syconn_tpu.skeleton import sparsify as js
    from syconn_tpu_torch.skeleton import sparsify as ts

    sk = _grid_skeleton(seed)
    scale = (10.0, 10.0, 20.0)
    for kw in (dict(min_dist_nm=25.0), dict(min_dist_nm=60.0, angle_thresh_deg=120.0)):
        _same_skel(ts.sparsify_skeleton(sk, scale=scale, **kw),
                   js.sparsify_skeleton(sk, scale=scale, **kw))
    for thr in (50.0, 200.0):
        _same_skel(ts.prune_stub_branches(sk, scale=scale, len_thres_nm=thr),
                   js.prune_stub_branches(sk, scale=scale, len_thres_nm=thr))
    # fragments on one grid: stitching picks among equal distances
    parts = []
    for k in range(4):
        p = _grid_skeleton(seed * 10 + k, n=30)
        p["nodes"] = p["nodes"] + np.float32(k * 7)
        parts.append(p)
    parts.append(None)
    ref = js.merge_skeletons(parts, scale=scale, stitch=True)
    got = ts.merge_skeletons(parts, scale=scale, stitch=True)
    _same_skel(got, ref)
    assert nx.is_connected(js.skeleton_to_nx(ref))
    assert ts.skeleton_to_nx(got).is_connected()
    _same_skel(ts.merge_skeletons(parts, scale=scale, stitch=False),
               js.merge_skeletons(parts, scale=scale, stitch=False))
    assert ts.merge_skeletons([None]) is None


def test_majority_vote_equals_jax():
    from syconn_tpu.proc.skeleton import majorityvote_skeleton_property as jvote
    from syconn_tpu_torch.proc.skeleton import majorityvote_skeleton_property

    sk = _grid_skeleton(7, n=200)
    sk["myelin"] = (np.random.default_rng(3).random(200) > 0.6).astype(np.uint8)
    for window in (100.0, 400.0, 10000.0):
        ref = jvote(sk, "myelin", window, (10, 10, 20))
        got = majorityvote_skeleton_property(sk, "myelin", window, (10, 10, 20))
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", range(3))
def test_adjacency_graph_iterates_as_networkx(seed):
    from syconn_tpu_torch.proc.graphs import AdjacencyGraph

    r = random.Random(seed)
    n = 300
    g, a = nx.Graph(), AdjacencyGraph()
    for i in r.sample(range(n), n):
        g.add_node(i)
        a.add_node(i)
    for _ in range(400):
        op = r.random()
        u, v = r.randrange(n), r.randrange(n)
        if op < 0.7 and u != v and u in g and v in g:
            g.add_edge(u, v)
            a.add_edge(u, v)
        elif op >= 0.7 and u in g:
            g.remove_node(u)
            a.remove_node(u)
    assert list(g.nodes()) == list(a.nodes)
    assert list(g.edges()) == a.edges()
    assert [list(c) for c in nx.connected_components(g)] == \
        [list(c) for c in a.connected_components()]
    for x in g:
        assert list(g.neighbors(x)) == list(a.neighbors(x)) and g.degree(x) == a.degree(x)
    drop = r.sample(list(g.nodes()), 20) + [n + 5]
    g.remove_nodes_from(drop)
    a.remove_nodes_from(drop)
    assert list(g.edges()) == a.edges() and a.number_of_nodes() == g.number_of_nodes()


def _twin_graphs(seed, n=120, n_edges=220):
    """The same seeded graph as ``networkx.Graph`` and ``AdjacencyGraph``,
    nodes and edges inserted in one shuffled order: several components,
    cycles, and many nodes at equal BFS depth."""
    from syconn_tpu_torch.proc.graphs import AdjacencyGraph

    r = random.Random(seed)
    g, a = nx.Graph(), AdjacencyGraph()
    for i in r.sample(range(n), n):
        g.add_node(i)
        a.add_node(i)
    for _ in range(n_edges):
        u, v = r.randrange(n), r.randrange(n // 2) * 2
        if u != v:
            g.add_edge(u, v)
            a.add_edge(u, v)
    return g, a, r


@pytest.mark.parametrize("seed", range(3))
def test_graph_windows_equal_jax(seed):
    from syconn_tpu.proc import graphs as J
    from syconn_tpu_torch.proc import graphs as T

    g, a, r = _twin_graphs(seed)
    for source in r.sample(list(g.nodes()), 5):
        assert list(nx.bfs_tree(g, source)) == T.bfs_order(a, source)
    starts = r.sample(list(g.nodes()), 30)
    for max_nb in (1, 4, 17, 500):
        assert T.split_subcc(a, max_nb) == J.split_subcc(g, max_nb)
        assert T.split_subcc(a, max_nb, start_nodes=starts) == \
            J.split_subcc(g, max_nb, start_nodes=starts)
    for size, lo in ((1, 1), (5, 1), (8, 3), (40, 0), (500, 2)):
        assert T.split_subcc_join(a, size, lo) == J.split_subcc_join(g, size, lo)
    for n_chunks in (0, 1, 7, 500):
        assert T.chunkify_graph_bfs(a, n_chunks) == J.chunkify_graph_bfs(g, n_chunks)

    # grid vertices: many neighbours at equal distances, labels with tied votes
    rng = np.random.default_rng(seed)
    verts = np.stack(np.meshgrid(*[np.arange(6) * 100.0] * 3, indexing="ij"), -1).reshape(-1, 3)
    verts = verts[rng.permutation(len(verts))]
    labels = rng.integers(0, 4, len(verts))
    for n_voting, max_len in ((1, 250), (7, 150), (7, 100.0), (40, 250), (300, 1e9)):
        got = T.bfs_smoothing(verts, labels, n_voting, max_len)
        ref = J.bfs_smoothing(verts, labels, n_voting, max_len)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), (n_voting, max_len)
