"""Step 2 as the datasets it writes: both packages run
``init_cell_subcell_sds`` and ``run_create_rag`` from identical cell
segmentations and probability maps in two working directories (the world of
tests/test_sd_proc.py, with ``tpu.shard_pipeline: false``), and the numpy
caches, per-shard attribute dicts, meshes and voxel stores of 'sv', 'mi' and
'vc', and the pruned supervoxel graph, are equal. Also the graph IO and
component sizes without networkx."""

import bz2
import os
import pickle

import numpy as np
import pytest
import torch

from _torch_helpers import compare_datasets, jax_defaults_isolated, port_wd

SH = (64, 64, 32)
CHUNK = (32, 32, 32)
CONF = [("tpu", {"shard_pipeline": False}), ("min_cc_size_ssv", 450)]


@pytest.fixture(autouse=True)
def _jax_defaults():
    """Nested overrides in the JAX working directories leave the JAX
    package's defaults as they were for the rest of the process."""
    with jax_defaults_isolated():
        yield


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _blobs(centres, radii, rng):
    x, y, z = np.ogrid[:SH[0], :SH[1], :SH[2]]
    prob = rng.integers(0, 40, SH).astype(np.uint8)
    for c in centres:
        d2 = sum(((a - ci) / r) ** 2 for a, ci, r in zip((x, y, z), c, radii))
        prob = np.maximum(prob, np.where(d2 <= 1, 255 * (1 - 0.5 * d2), 0).astype(np.uint8))
    return prob


def world():
    """tests/test_sd_proc.py's two cells, small supervoxels in the top
    layer, and mi/vc probability maps with blobs inside and across cells."""
    rng = np.random.default_rng(3)
    cell = np.zeros(SH, np.uint64)
    cell[4:30, 4:60, 4:28] = 10
    cell[34:60, 4:60, 4:28] = 22
    small = (np.arange(64, dtype=np.uint64).reshape(8, 8) + 100)
    cell[:, :, 28:] = np.repeat(np.repeat(small, 8, 0), 8, 1)[:, :, None]
    mi = _blobs([(17, 22, 16), (47, 22, 16), (32, 50, 12)], (11, 11, 6), rng)
    vc = _blobs([(10, 50, 10), (20, 12, 20), (50, 12, 8), (52, 52, 20)], (5, 5, 3), rng)
    ids = np.unique(cell)[1:]
    edges = rng.choice(ids, size=(40, 2))
    edges = np.concatenate([edges, [[10, 22], [9999, 100], [22, 10], [101, 101]]]).astype(np.uint64)
    return cell, {"mi": mi, "vc": vc}, {"edges": edges, "nodes": None}


def make_wd(wd, package, cell, probs, rag, conf=CONF):
    """A working directory of ``package`` (its own config and chunk store)
    holding ``cell`` and the probability maps, and the RAG."""
    if package == "jax":
        from syconn_tpu.handler.config import Config, generate_default_conf
        from syconn_tpu.io.chunked import ChunkedVolume
    else:
        from syconn_tpu_torch.handler.config import Config, generate_default_conf
        from syconn_tpu_torch.io.chunked import ChunkedVolume
    generate_default_conf(wd, scaling=(10, 10, 20), key_value_pairs=conf)
    cfg = Config(wd)
    ChunkedVolume.create(cfg.kd_seg_path, scale=(10, 10, 20), boundary=SH,
                         chunk_shape=CHUNK).save_seg(cell)
    for co, prob in probs.items():
        ChunkedVolume.create(cfg.kd_organelle_proba_paths[co], scale=(10, 10, 20), boundary=SH,
                             chunk_shape=CHUNK).save_raw(prob)
    with bz2.open(cfg.init_svgraph_path, "wb") as f:
        pickle.dump(rag, f, protocol=4)
    return cfg


def run_jax_step2(wd):
    from syconn_tpu import global_params
    from syconn_tpu.exec import exec_init
    from syconn_tpu.handler.basics import clear_kd_cache

    clear_kd_cache()
    prev = global_params.wd
    global_params.wd = wd
    try:
        counts = exec_init.init_cell_subcell_sds(chunk_size=CHUNK)
        pruned = exec_init.run_create_rag()
    finally:
        global_params.wd = prev
    return counts, pruned


def run_port_step2(wd):
    from syconn_tpu_torch.exec import exec_init
    from syconn_tpu_torch.handler.basics import clear_kd_cache

    clear_kd_cache()
    with port_wd(wd):
        counts = exec_init.init_cell_subcell_sds(chunk_size=CHUNK, device="cpu")
        pruned = exec_init.run_create_rag()
    return counts, pruned


def edge_set(edges):
    return {tuple(sorted((int(a), int(b)))) for a, b in np.asarray(edges).reshape(-1, 2)}


def test_step2_datasets_and_pruned_graph_equal_jax(tmp_path):
    from syconn_tpu.io.graph import load_svgraph as jload
    from syconn_tpu_torch.io.graph import load_svgraph

    cell, probs, rag = world()
    wj, wt = str(tmp_path / "jax"), str(tmp_path / "port")
    make_wd(wj, "jax", cell, probs, rag)
    make_wd(wt, "port", cell, probs, rag)
    cj, pj = run_jax_step2(wj)
    ct, pt = run_port_step2(wt)
    assert {k: v for k, v in ct.items() if k != "stats"} == cj
    assert cj["mi"] >= 3 and cj["vc"] >= 3 and cj["sv"] == 66
    assert ct["stats"]["scan"]["mesh_seconds"] > 0
    compare_datasets(wj, wt, ["sv", "mi", "vc"])
    # the pruned graph, as each package saved it and as the port reads both
    gj, gt = jload(os.path.join(wj, "pruned_svgraph.bz2")), load_svgraph(
        os.path.join(wt, "pruned_svgraph.bz2"))
    assert set(gj.nodes()) == set(gt["nodes"].tolist()) == set(pt["nodes"].tolist())
    assert edge_set(list(gj.edges())) == edge_set(gt["edges"]) == edge_set(pj.edges())
    assert set(load_svgraph(os.path.join(wj, "pruned_svgraph.bz2"))["nodes"].tolist()) == \
        set(gj.nodes())
    # 9999 has no supervoxel: it takes its component's size
    assert 0 < len(gt["nodes"]) < len(np.unique(cell)) and 9999 in gt["nodes"]


def test_step2_resumes_without_recomputing(tmp_path):
    """A second run with ``overwrite=False`` keeps the complete organelle
    segmentations and resumes every scan chunk from the mesh-carrying
    cache; the datasets are unchanged."""
    from syconn_tpu_torch.exec import exec_init

    cell, probs, rag = world()
    wd = str(tmp_path / "port")
    make_wd(wd, "port", cell, probs, rag)
    first, _ = run_port_step2(wd)
    before = np.load(os.path.join(wd, "mis_0", "ids.npy"))
    with port_wd(wd):
        again = exec_init.init_cell_subcell_sds(chunk_size=CHUNK, device="cpu")
    assert again["stats"]["extraction"] == {"mi": None, "vc": None}
    assert again["stats"]["scan"]["resumed"] == 4
    assert {k: v for k, v in again.items() if k != "stats"} == \
        {k: v for k, v in first.items() if k != "stats"}
    assert np.array_equal(np.load(os.path.join(wd, "mis_0", "ids.npy")), before)
    assert os.path.isdir(os.path.join(wd, ".stepcache", "sd_props_mesh_sv"))


def test_segmentation_objects_read_back(tmp_path):
    """Objects of the written datasets: attributes, mesh and voxels through
    ``SegmentationDataset``/``SegmentationObject``."""
    from syconn_tpu_torch.reps.segmentation import SegmentationDataset

    cell, probs, rag = world()
    wd = str(tmp_path / "port")
    make_wd(wd, "port", cell, probs, rag)
    run_port_step2(wd)
    with port_wd(wd):
        sd = SegmentationDataset("sv")
        assert sd.exists() and sd.ids.tolist() == np.unique(cell)[1:].tolist()
        so = sd.get_segmentation_object(10)
        assert so.size == int((cell == 10).sum())
        mask, off = so.voxel_mask_offset()
        assert mask.sum() == so.size and np.array_equal(off, so.bounding_box[0])
        assert len(so.mesh[1]) > 0 and so.mesh_area > 0
        assert set(so.lookup_in_attribute_dict("mapping_mi_ids").tolist()) >= {1}
        sd_mi = SegmentationDataset("mi", cache_properties=["size"])
        mo = sd_mi.get_segmentation_object(int(sd_mi.ids[0]))
        assert mo.attr_dict["size"] == sd_mi.sizes[0]
        assert mo.lookup_in_attribute_dict("mapping_ids") is not None
        assert len(so.sample_locations()) >= 1
        with pytest.raises(NotImplementedError, match="render"):
            so.load_views()


def test_graph_io_and_component_sizes_without_networkx(tmp_path):
    import networkx as nx

    from syconn_tpu.io.graph import save_svgraph as jsave
    from syconn_tpu.proc.graphs import create_ccsize_dict as jccsize
    from syconn_tpu_torch.io.graph import load_svgraph, save_svgraph
    from syconn_tpu_torch.proc.graphs import create_ccsize_dict

    rng = np.random.default_rng(1)
    edges = rng.integers(1, 60, size=(50, 2)).astype(np.uint64)
    g = nx.Graph()
    g.add_edges_from((int(a), int(b)) for a, b in edges)
    g.add_nodes_from([70, 71])
    bbs = {n: np.sort(rng.integers(0, 5000, (2, 3)), axis=0).astype(np.float64)
           for n in range(1, 72) if n % 7}
    ref = jccsize(g, bbs)
    got = create_ccsize_dict({"edges": edges, "nodes": np.array([70, 71], np.uint64)}, bbs)
    assert got == ref
    # the dict form both packages write, the edge-array form, and refusal of networkx pickles
    jsave(g, str(tmp_path / "j.bz2"))
    loaded = load_svgraph(str(tmp_path / "j.bz2"))
    assert set(loaded["nodes"].tolist()) == set(g.nodes()) and \
        edge_set(loaded["edges"]) == edge_set(list(g.edges()))
    save_svgraph(loaded, str(tmp_path / "t.bz2"))
    from syconn_tpu.io.graph import load_svgraph as jload

    back = jload(str(tmp_path / "t.bz2"))
    assert set(back.nodes()) == set(g.nodes()) and edge_set(list(back.edges())) == edge_set(list(g.edges()))
    with open(tmp_path / "e.pkl", "wb") as f:
        pickle.dump(edges, f)
    assert edge_set(load_svgraph(str(tmp_path / "e.pkl"))["edges"]) == edge_set(edges)
    with bz2.open(tmp_path / "nx.bz2", "wb") as f:
        pickle.dump(g, f)
    with pytest.raises(ValueError, match="networkx"):
        load_svgraph(str(tmp_path / "nx.bz2"))
