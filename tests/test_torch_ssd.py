"""Cell assembly pieces of the port against the JAX package on the CPU:
``BinarySearchStore`` (the numpy container beside the JAX package's HDF5
one) answers the same lookups; astrocyte splitting (``remove_glia_nodes``,
``split_glia_graph``) on dict graphs gives the JAX package's partition on
networkx graphs, every component-size flip included; the kNN coordinate
graph equals networkx's edge for edge; ``SuperSegmentationObject`` keeps the
JAX package's SV-graph file format, and its later methods run (the kzip
export round trip; the card-only ones raise without a card).
Steps 3-4 as a whole: tests/test_torch_cells.py."""

import os
import pickle

import numpy as np
import pytest
import torch

nx = pytest.importorskip("networkx")


@pytest.mark.parametrize("n_shards", [1, 3, 10])
def test_binary_search_store_equals_jax(tmp_path, n_shards):
    from syconn_tpu.backend.bst import BinarySearchStore as JStore
    from syconn_tpu_torch.backend import BinarySearchStore

    rng = np.random.default_rng(n_shards)
    ids = rng.choice(10 ** 9, size=2000, replace=False).astype(np.uint64)
    attrs = {"ssv_ids": rng.integers(1, 10 ** 6, size=len(ids)).astype(np.uint64),
             "size": rng.integers(0, 100, size=len(ids)).astype(np.int64)}
    js = JStore(str(tmp_path / "s.h5"), ids, attrs, n_shards=n_shards)
    ts = BinarySearchStore(str(tmp_path / "s.npz"), ids, attrs, n_shards=n_shards)
    ts = BinarySearchStore(str(tmp_path / "s.npz"))  # reopened from disk
    assert ts.n_shards == js.n_shards
    np.testing.assert_array_equal(ts.id_array, js.id_array)
    assert sorted(ts.attr_names) == sorted(js.attr_names)
    q = rng.permutation(ids)[:700]
    for key in attrs:
        got, ref = ts.get_attributes(q, key), js.get_attributes(q, key)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(KeyError):
        ts.get_attributes(np.array([10 ** 9 + 7], np.uint64), "size")
    with pytest.raises(FileExistsError):
        BinarySearchStore(str(tmp_path / "s.npz"), ids, attrs)
    ts2 = pickle.loads(pickle.dumps(ts))
    np.testing.assert_array_equal(ts2.get_attributes(q, "size"), js.get_attributes(q, "size"))


def _random_graph(seed, n=60):
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(1, 10 ** 6), size=n, replace=False)
    edges = rng.choice(ids, size=(n, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    probas = {int(i): float(p) for i, p in zip(ids, rng.random(n))}
    lo = rng.integers(0, 500, (n, 3))
    bbs = {int(i): np.stack([l, l + rng.integers(1, 120, 3)]).astype(np.float64) * [10, 10, 20]
           for i, l in zip(ids, lo)}
    return ids, edges, probas, bbs


@pytest.mark.parametrize("seed", range(6))
def test_glia_split_equals_jax(seed):
    from syconn_tpu.proc.graphs import remove_glia_nodes as jremove
    from syconn_tpu.proc.graphs import split_glia_graph as jsplit
    from syconn_tpu_torch.proc.graphs import remove_glia_nodes, split_glia_graph

    ids, edges, probas, bbs = _random_graph(seed)
    g = {"edges": edges.astype(np.uint64), "nodes": ids.astype(np.uint64)}
    jg = nx.Graph()
    jg.add_nodes_from(int(i) for i in ids)
    jg.add_edges_from((int(a), int(b)) for a, b in edges)
    flips = 0
    for thresh, min_cc in ((0.5, 0.0), (0.3, 2000.0), (0.7, 6000.0)):
        ref = jremove(jg, probas, thresh, min_cc, bbs=bbs)
        got = remove_glia_nodes(g, probas, thresh, min_cc, bbs=bbs)
        assert got == ref
        plain = {int(i) for i in ids if probas[int(i)] > thresh}
        flips += len(plain ^ set(got[1]))
        jn, jgl = jsplit(jg, probas, thresh, min_cc, bbs=bbs)
        tn, tgl = split_glia_graph(g, probas, thresh, min_cc, bbs=bbs)
        for a, b in ((jn, tn), (jgl, tgl)):
            assert set(a.nodes()) == set(b["nodes"].tolist())
            assert {tuple(sorted(e)) for e in a.edges()} == \
                {tuple(sorted((int(x), int(y)))) for x, y in b["edges"]}
    assert flips > 0  # the component-size flips took part


def test_graph_from_coords_equals_networkx():
    from syconn_tpu.proc.graphs import create_graph_from_coords as jgraph
    from syconn_tpu_torch.proc.graphs import create_graph_from_coords

    rng = np.random.default_rng(2)
    coords = np.concatenate([rng.random((40, 3)) * 3000, rng.random((30, 3)) * 3000 + 20000,
                             rng.random((5, 3)) * 100 + 50000])
    for force in (False, True):
        ref = jgraph(coords, max_dist_nm=2000, force_single_cc=force)
        got = create_graph_from_coords(coords, max_dist_nm=2000, force_single_cc=force)
        assert list(ref.nodes()) == list(got.nodes)
        assert list(ref.edges()) == got.edges()
        assert [ref.edges[e]["weight"] for e in ref.edges()] == \
            [got._adj[a][b]["weight"] for a, b in got.edges()]
        assert got.is_connected() == force


def test_sso_sv_graph_file_and_later_methods(tmp_path, monkeypatch):
    from _torch_helpers import port_wd
    from syconn_tpu.handler.basics import load_pkl2obj
    from syconn_tpu_torch.handler.config import generate_default_conf
    from syconn_tpu_torch.reps.super_segmentation import (SuperSegmentationDataset,
                                                          SuperSegmentationObject)

    wd = str(tmp_path / "wd")
    generate_default_conf(wd, scaling=(10, 10, 20))
    ssd = SuperSegmentationDataset(working_dir=wd, sv_mapping={3: [3, 7, 9]}, create=True)
    sso = ssd.get_super_segmentation_object(3)
    os.makedirs(sso.ssv_dir, exist_ok=True)
    chain = sso.load_sv_graph()  # no stored graph: a chain in id order
    assert chain["edges"].tolist() == [[3, 7], [7, 9]]
    sso.save_sv_graph({"edges": np.array([[3, 9], [9, 7]], np.uint64),
                       "nodes": np.array([3, 7, 9], np.uint64)})
    stored = load_pkl2obj(sso.sv_graph_path)  # the JAX package's reader
    assert stored == [(3, 9), (9, 7)] and all(type(x) is int for e in stored for x in e)
    again = SuperSegmentationObject(3, ssd=SuperSegmentationDataset(working_dir=wd))
    assert again.load_sv_graph()["edges"].tolist() == [[3, 9], [9, 7]]
    assert again.sv_ids.tolist() == [3, 7, 9]
    ssd.build_sv2ssv_index()
    assert ssd.sv2ssv_ids(np.array([9, 3], np.uint64)).tolist() == [3, 3]
    # the kzip export round trip: this cell has no mesh and no skeleton, so
    # the archive holds its id, scaling and attributes (``sv_ids`` as
    # save_dataset_deep would have written them)
    from syconn_tpu_torch.proc.ssd_assembly import init_sso_from_kzip

    sso.save_attributes(["sv_ids"], [sso.sv_ids])
    path = sso.export2kzip(str(tmp_path / "cell.k.zip"))
    back = init_sso_from_kzip(path)
    assert back._standalone and back.id == 3 and back.sv_ids.tolist() == [3, 7, 9]
    np.testing.assert_array_equal(back.scaling, sso.scaling)
    assert len(back.load_mesh("sv")[1]) == 0 and not back.load_skeleton()
    # steps 7-9 and the views are ported: the cell type runs the celltype
    # net and the views the renderer (here the card is hidden, so both ask
    # for one), and a cell without spine labels has no spine compartments
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sso.predict_celltype()
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            sso.render_views(**kw)
    # this cell has no mesh: no sampled locations, and background everywhere
    with port_wd(wd):
        assert len(sso.render_views(device="cpu")) == 0
        views = sso.render_views(np.zeros((2, 3)), ws=(32, 16), nb_views=2, device="cpu")
        index = sso.render_indexviews(np.zeros((2, 3)), ws=(32, 16), nb_views=2, device="cpu")
    assert views.shape == (2, 2, 4, 32, 16) and (views == 255).all()
    assert index.shape == (2, 2, 32, 16) and (index == -1).all()
    assert all(len(x) == 0 for x in sso.get_spine_compartments())
