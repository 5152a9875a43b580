"""``split_ssv`` of the port against the JAX package on the CPU, on the
world of ``tests/test_ssd.py::test_split_ssv_roundtrip`` (96x96x48, 3 cells
of 2 SVs, organelles mapped; steps 2 and 4 by the JAX package): each
package splits the same cell in its own copy of the working directory, and
the new ids, attribute dicts (the tombstone included), mapping dict,
``{attr}s.npy`` caches, stored SV-graph edge lists (networkx's order and
orientation) and skeleton halves are equal; the reverse index answers
alike for every SV."""

import glob
import os
import pickle
import shutil

import numpy as np
import pytest

from _torch_helpers import _same, jax_defaults_isolated, port_wd

pytest.importorskip("networkx")


@pytest.fixture(scope="module")
def jax_ssd_wd(tmp_path_factory):
    """The JAX package's working directory: steps 2 and 4 on the world."""
    from syconn_tpu import global_params
    from syconn_tpu.exec.exec_init import (init_cell_subcell_sds, run_create_neuron_ssd,
                                           run_create_rag)
    from syconn_tpu.handler.basics import clear_kd_cache
    from syconn_tpu.handler.config import generate_default_conf
    from syconn_tpu.io.chunked import ChunkedVolume
    from syconn_tpu.io.graph import save_svgraph
    from syconn_tpu.utils.testdata import generate_toy_world

    wd = str(tmp_path_factory.mktemp("split") / "wd")
    prev = global_params.wd
    clear_kd_cache()
    with jax_defaults_isolated():
        generate_default_conf(
            wd, scaling=(10, 10, 20),
            key_value_pairs=[("min_cc_size_ssv", 200), ("cell_objects", {
                "extract_morph_op": {"mi": ["binary_closing"], "vc": ["binary_closing"],
                                     "sj": []},
                "min_obj_vx": {"mi": 100, "vc": 50, "sj": 20},
                "sizethresholds": {"mi": 100, "vc": 50, "sj": 20}})],
            force_overwrite=True)
        try:
            global_params.wd = wd
            global_params.config._parse_config()
            cfg = global_params.config
            world = generate_toy_world(shape=(96, 96, 48), n_cells=3, svs_per_cell=2, seed=0)
            kd = ChunkedVolume.create(cfg.kd_seg_path, scale=(10, 10, 20),
                                      boundary=world["seg"].shape, chunk_shape=(64, 64, 64))
            kd.save_raw(world["raw"])
            kd.save_seg(world["seg"])
            for co in ["mi", "vc", "sj"]:
                ChunkedVolume.create(getattr(cfg, f"kd_{co}_path"), scale=(10, 10, 20),
                                     boundary=world["seg"].shape,
                                     chunk_shape=(64, 64, 64)).save_raw(world[co])
            save_svgraph(world["rag"], cfg.init_svgraph_path)
            init_cell_subcell_sds(chunk_size=(64, 64, 64), overwrite=True)
            run_create_rag()
            run_create_neuron_ssd()
        finally:
            global_params.wd = prev
            clear_kd_cache()
    return wd


def _ssv_state(wd, lookup):
    """Everything ``split_ssv`` writes under ``<wd>/ssv_0``, decoded."""
    from syconn_tpu_torch.backend import AttributeDict, SkeletonStorage

    d = os.path.join(wd, "ssv_0")
    out = {"npy": {os.path.basename(p): np.load(p, allow_pickle=True)
                   for p in sorted(glob.glob(os.path.join(d, "*.npy")))}}
    with open(os.path.join(d, "mapping_dict.pkl"), "rb") as f:
        out["mapping_dict"] = pickle.load(f)
    for p in sorted(glob.glob(os.path.join(d, "so_storage", "**", "*.pkl"), recursive=True)):
        rel = os.path.relpath(p, d)
        if rel.endswith("attr_dict.pkl"):
            ad = AttributeDict(p, read_only=True)
            out[rel] = {k: ad[k] for k in sorted(ad.keys())}
        elif rel.endswith("skeletons.pkl"):
            ss = SkeletonStorage(p, read_only=True)
            out[rel] = {k: ss[k] for k in sorted(ss.keys())}
        elif rel.endswith("_svgraph.pkl"):
            with open(p, "rb") as f:
                out[rel] = pickle.load(f)
    all_svs = np.concatenate([np.asarray(v, np.uint64) for v in out["mapping_dict"].values()])
    out["sv2ssv"] = np.asarray(lookup(np.sort(all_svs)))
    return out


@pytest.mark.parametrize("case", ["first_half", "second_half"])
def test_split_ssv_equals_jax(jax_ssd_wd, tmp_path, case):
    from syconn_tpu import global_params as jparams
    from syconn_tpu.proc.ssd_proc import split_ssv as jsplit
    from syconn_tpu.reps.segmentation import SegmentationDataset as JSD
    from syconn_tpu.reps.super_segmentation import SuperSegmentationDataset as JSSD
    from syconn_tpu_torch.proc.ssd_proc import split_ssv
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset

    wj, wt = str(tmp_path / "wj"), str(tmp_path / "wt")
    shutil.copytree(jax_ssd_wd, wj)
    shutil.copytree(jax_ssd_wd, wt)
    jssd = JSSD(working_dir=wj)
    cand = [int(i) for i in jssd.ssv_ids if len(jssd.mapping_dict[int(i)]) >= 2]
    assert cand, "the world must hold a multi-SV cell"
    orig_id = cand[0] if case == "first_half" else cand[-1]
    orig_svs = sorted(int(s) for s in jssd.mapping_dict[orig_id])
    split_set = orig_svs[: len(orig_svs) // 2] if case == "first_half" else orig_svs[-1:]
    # a skeleton spanning the SVs' rep coords, as in tests/test_ssd.py
    sd_sv = JSD("sv", working_dir=wj)
    reps = dict(zip(sd_sv.ids.tolist(), sd_sv.rep_coords))
    nodes = np.array([reps[s] for s in orig_svs], np.float32)
    skel = {"nodes": nodes,
            "edges": np.array([[i, i + 1] for i in range(len(nodes) - 1)], np.int64),
            "diameters": np.ones(len(nodes))}

    prev = jparams.wd
    jparams.wd = wj
    try:
        jssv = jssd.get_super_segmentation_object(orig_id)
        jssv.load_attr_dict()
        jssv.skeleton = dict(skel)
        jssv.save_skeleton()
        j1, j2 = jsplit(jssv, split_set)
        jlookup = JSSD(working_dir=wj).sv2ssv_ids
        ref = _ssv_state(wj, jlookup)
    finally:
        jparams.wd = prev
    with port_wd(wt):
        tssd = SuperSegmentationDataset(working_dir=wt)
        tssv = tssd.get_super_segmentation_object(orig_id)
        tssv.load_attr_dict()
        tssv.skeleton = dict(skel)
        tssv.save_skeleton()
        t1, t2 = split_ssv(tssv, split_set)
        got = _ssv_state(wt, SuperSegmentationDataset(working_dir=wt).sv2ssv_ids)

    assert (t1.id, t2.id) == (j1.id, j2.id)
    assert sorted(t2.sv_ids.tolist()) == sorted(split_set)
    assert sorted(t1.sv_ids.tolist() + t2.sv_ids.tolist()) == orig_svs
    assert int(t1.attr_dict["size"]) + int(t2.attr_dict["size"]) == int(jssv.attr_dict["size"])
    assert set(got) == set(ref)
    for key in ref:
        _same(got[key], ref[key], key)
    # the tombstone, the new cells' graphs and skeleton halves are there
    shard = [k for k in ref if k.endswith("attr_dict.pkl")]
    assert any(v.get(orig_id, {}).get("split_into") == (t1.id, t2.id)
               for k in shard for v in [ref[k]])
    assert {t1.id, t2.id} <= {int(i) for i in ref["npy"]["ids.npy"]}
    assert orig_id not in {int(i) for i in ref["npy"]["ids.npy"]}
    graphs = [k for k in ref if k.endswith(f"{t1.id}_svgraph.pkl") or
              k.endswith(f"{t2.id}_svgraph.pkl")]
    assert len(graphs) == 2
    assert np.array_equal(got["sv2ssv"], ref["sv2ssv"])


@pytest.mark.parametrize("seed", range(4))
def test_subgraph_order_equals_networkx(seed):
    """``AdjacencyGraph.subgraph`` (the induced graph ``split_ssv`` stores)
    against ``networkx.Graph.subgraph(nodes).copy()``: the same nodes and
    edges in the same order and orientation, on sides smaller and larger
    than half the graph (networkx then walks a set or the graph)."""
    import networkx as nx

    from syconn_tpu_torch.proc.graphs import AdjacencyGraph

    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(2, 40))
        ids = [int(x) for x in rng.choice(np.arange(1, 5000), n, replace=False)]
        edges = [(int(a), int(b)) for a, b in rng.choice(ids, (int(rng.integers(0, 3 * n)), 2))]
        g = nx.Graph()
        g.add_nodes_from(ids)
        g.add_edges_from(edges)
        a = AdjacencyGraph()
        for i in ids:
            a.add_node(i)
        for u, v in edges:
            a.add_edge(u, v)
        side = [ids[i] for i in sorted(rng.choice(n, int(rng.integers(1, n)), replace=False))]
        ref, got = g.subgraph(side).copy(), a.subgraph(side)
        assert list(ref.nodes()) == list(got.nodes)
        assert list(ref.edges()) == got.edges()
