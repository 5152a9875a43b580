"""The cell helpers of steps 7-9 (``reps/super_segmentation_helper.py``)
against the JAX package on seeded skeletons and meshes: geodesic distance to
the soma (scipy's Dijkstra against networkx's), the compartment vote per
unbranched segment, labels at coordinates (vertex majority and the skeleton
fallback), and the mesh-based skeleton (Kruskal's tree against networkx's).
The skeletons lie on a unit lattice, so equal-length edges and paths, and
equal kNN distances, are everywhere: the tie rules decide the results."""

import numpy as np
import pytest


class _Cell:
    """The few members of a SuperSegmentationObject the helpers read."""

    id = 5

    def __init__(self, skeleton=None, mesh=None, attrs=None, scaling=(10.0, 10.0, 20.0)):
        self.skeleton = skeleton
        self.mesh = mesh
        self.attr_dict = dict(attrs or {})
        self.scaling = np.asarray(scaling, np.float64)

    def load_skeleton(self):
        return self.skeleton is not None

    def lookup_in_attribute_dict(self, key, default=None):
        return self.attr_dict.get(key, default)

    def load_mesh(self, obj_type="sv"):
        return self.mesh


def _lattice_skeleton(seed, n=120, n_cycles=15):
    """A random tree grown on a unit lattice plus a few closing edges
    (equal-length alternative paths), labels 0/1/2 in runs."""
    rng = np.random.default_rng(seed)
    pos = [(0, 0, 0)]
    index = {(0, 0, 0): 0}
    edges = []
    steps = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    while len(pos) < n:
        a = int(rng.integers(len(pos)))
        s = steps[int(rng.integers(6))]
        p = tuple(int(x + y) for x, y in zip(pos[a], s))
        if p in index:
            continue
        index[p] = len(pos)
        pos.append(p)
        edges.append((a, index[p]))
    have = {tuple(sorted(e)) for e in edges}
    added = 0
    for p, i in index.items():
        for s in steps[::2]:
            q = tuple(int(x + y) for x, y in zip(p, s))
            j = index.get(q)
            if j is not None and tuple(sorted((i, j))) not in have and added < n_cycles:
                edges.append((i, j))
                have.add(tuple(sorted((i, j))))
                added += 1
    nodes = np.array(pos, np.float32) * 4 + 50
    labels = np.repeat(rng.integers(0, 3, n // 6 + 1), 6)[:n].astype(np.int64)
    return {"nodes": nodes, "edges": np.array(edges, np.int64),
            "diameters": np.ones(n, np.float32), "axoness": labels}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shortestpath2soma_and_compartment_vote_equal_jax(seed):
    from syconn_tpu.reps import super_segmentation_helper as jh
    from syconn_tpu_torch.reps import super_segmentation_helper as th

    sk = _lattice_skeleton(seed)
    rng = np.random.default_rng(seed + 10)
    coords = sk["nodes"][rng.integers(0, len(sk["nodes"]), 40)] + rng.integers(-3, 4, (40, 3))
    dj = jh.shortestpath2soma(_Cell(sk), coords)
    dt = th.shortestpath2soma(_Cell(sk), coords)
    assert np.array_equal(dj, dt) and np.isfinite(dt).any()
    no_soma = dict(sk, axoness=np.where(sk["axoness"] == 2, 0, sk["axoness"]))
    assert np.isinf(th.shortestpath2soma(_Cell(no_soma), coords)).all()
    # a zero-length edge (two nodes at one position) stays an edge
    dup = dict(sk, nodes=np.concatenate([sk["nodes"], sk["nodes"][:1]]),
               edges=np.concatenate([sk["edges"], [[0, len(sk["nodes"])]]]),
               axoness=np.concatenate([sk["axoness"], [2]]))
    assert np.array_equal(jh.shortestpath2soma(_Cell(dup), coords),
                          th.shortestpath2soma(_Cell(dup), coords))
    for key in ("axoness",):
        vj = jh.majority_vote_compartments(sk, key)
        vt = th.majority_vote_compartments(sk, key)
        assert vj.dtype == vt.dtype and np.array_equal(vj, vt)


@pytest.mark.parametrize("seed", [0, 1])
def test_semseg_for_coords_equal_jax(seed):
    from syconn_tpu.reps import super_segmentation_helper as jh
    from syconn_tpu_torch.reps import super_segmentation_helper as th

    rng = np.random.default_rng(seed)
    verts = (rng.integers(0, 30, (600, 3)) * 20.0).astype(np.float32)  # lattice: ties
    labels = rng.integers(0, 4, 600).astype(np.uint8)
    mesh = [np.zeros(0, np.int64), verts.reshape(-1), np.zeros(0, np.float32)]
    cell = _Cell(mesh=mesh, attrs={"spiness_vertex_labels": labels})
    q = rng.integers(0, 60, (50, 3))
    for kw in ({}, {"k": 7}, {"k": 20, "ignore_labels": [3]}):
        a = jh.semseg_for_coords(cell, q, "spiness", **kw)
        b = th.semseg_for_coords(cell, q, "spiness", **kw)
        assert a.dtype == b.dtype and np.array_equal(a, b), kw
    sk = _lattice_skeleton(seed)
    bare = _Cell(skeleton=sk, mesh=[np.zeros(0), np.zeros(0), np.zeros(0)])
    assert np.array_equal(jh.semseg_for_coords(bare, q), th.semseg_for_coords(bare, q))
    with pytest.raises(ValueError):
        th.semseg_for_coords(_Cell(mesh=mesh), q, "axoness")


@pytest.mark.parametrize("seed", [0, 1])
def test_create_sso_skeleton_fast_equal_jax(seed):
    from syconn_tpu.reps import super_segmentation_helper as jh
    from syconn_tpu_torch.mesh.surface_nets import surface_net_mesh
    from syconn_tpu_torch.reps import super_segmentation_helper as th

    rng = np.random.default_rng(seed)
    mask = np.zeros((40, 30, 20), bool)
    mask[5:35, 10:16, 8:12] = True  # a bar with a side branch
    mask[18:22, 10:28, 8:12] = True
    mask[rng.integers(5, 35), 10:16, 8:12] = False
    ind, vert, norm = surface_net_mesh(mask, scale=(10, 10, 20))
    mesh = [ind, vert, norm]
    for ds in (60.0, 100.0):
        a = jh.create_sso_skeleton_fast(_Cell(mesh=mesh), ds_factor_nm=ds, save=False)
        b = th.create_sso_skeleton_fast(_Cell(mesh=mesh), ds_factor_nm=ds, save=False)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (ds, k)
        assert len(b["nodes"]) > 3
