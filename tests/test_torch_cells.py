"""Steps 3-5 of the port against the JAX package, through each package's
working-directory configuration, on the toy worlds of
tests/test_inference_points.py (two cells, one chunk) and
tests/test_skeleton.py (three cells, 64^3 cubes): both packages run steps
2-5 from the same volumes, organelle probability maps, RAG and seeded myelin
map in two working directories, and write

* the same pruned, neuron and astrocyte graphs (step 3's split identical;
  the glia probabilities within ``GLIA_ATOL``, an SV whose JAX probability
  lies that close to ``glia_thresh`` is named in the failure message);
* the same SSD (step 4): numpy caches, mapping dict, attribute dicts with
  ``mapping_{mi,vc}_ids/ratios`` and the decided lists, per-cell SV graphs
  and reverse-index lookups;
* the same skeletons (step 5) in canonical form (node rows sorted; diameter,
  ``myelin`` and ``myelin_avg10000`` per node; edges as sets of endpoint
  positions).

Stores are read through the port's readers (they read the payloads of both
packages).
"""

import bz2
import glob
import os
import pickle

import numpy as np
import pytest
import torch

from _torch_helpers import _same, jax_defaults_isolated, port_wd

WORLDS = {
    "inference_world": dict(shape=(96, 96, 48), n_cells=2, svs_per_cell=2, seed=4,
                            chunk=(96, 96, 48)),
    "skeleton_world": dict(shape=(96, 96, 48), n_cells=3, svs_per_cell=2, seed=2,
                           chunk=(64, 64, 64)),
}
CONF = [("tpu", {"shard_pipeline": False}), ("min_cc_size_ssv", 200),
        ("glia", {"prior_astrocyte_removal": True}),
        ("skeleton", {"kimimaro_skelgen": {"dust_threshold": 100},
                      "kimimaro_merge": {"dust_threshold": 100, "tick_threshold": 200}}),
        ("cell_objects", {"min_obj_vx": {"mi": 100},
                          "min_seed_vx": {"mi": 10},
                          "extract_morph_op": {"mi": ["binary_opening", "binary_closing",
                                                      "binary_erosion"]}})]
# glia probability (an SV's mean class-1 softmax): the JAX pipeline runs the
# net jitted, which differs from flax's eager apply by a median relative
# 1e-3 in the logits (XLA fuses the LayerNorm reductions; the port follows
# eager apply to ~1e-7, tests/test_torch_pointnet.py); on these worlds the
# probabilities differ by at most 0.004
GLIA_ATOL = 1e-2


@pytest.fixture(autouse=True)
def _jax_defaults():
    with jax_defaults_isolated():
        yield


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _make_wd(wd, package, world, chunk, myelin):
    if package == "jax":
        from syconn_tpu.handler.config import Config, generate_default_conf
        from syconn_tpu.io.chunked import ChunkedVolume
    else:
        from syconn_tpu_torch.handler.config import Config, generate_default_conf
        from syconn_tpu_torch.io.chunked import ChunkedVolume
    generate_default_conf(wd, scaling=(10, 10, 20), key_value_pairs=CONF)
    cfg = Config(wd)
    sh = world["seg"].shape
    kd = ChunkedVolume.create(cfg.kd_seg_path, scale=(10, 10, 20), boundary=sh, chunk_shape=chunk)
    kd.save_raw(world["raw"])
    kd.save_seg(world["seg"])
    for co in ("mi", "vc"):
        ChunkedVolume.create(cfg.kd_organelle_proba_paths[co], scale=(10, 10, 20), boundary=sh,
                             chunk_shape=chunk).save_raw(world[co])
    ChunkedVolume.create(cfg.kd_myelin_path, scale=(10, 10, 20), boundary=sh,
                         chunk_shape=chunk).save_raw(myelin)
    with bz2.open(cfg.init_svgraph_path, "wb") as f:
        pickle.dump({"edges": world["rag"], "nodes": None}, f, protocol=4)
    return cfg


def _run_jax(wd, chunk):
    from syconn_tpu import global_params
    from syconn_tpu.exec import exec_inference, exec_init, exec_skeleton
    from syconn_tpu.handler.basics import clear_kd_cache

    clear_kd_cache()
    prev = global_params.wd
    global_params.wd = wd
    try:
        exec_init.init_cell_subcell_sds(chunk_size=chunk)
        exec_init.run_create_rag()
        exec_inference.run_astrocyte_prediction_pts()
        split = exec_inference.run_astrocyte_splitting()
        exec_init.run_create_neuron_ssd()
        n = exec_skeleton.run_skeleton_generation(map_myelin=True, cube_size=chunk)
    finally:
        global_params.wd = prev
    return split, n


def _run_port(wd, chunk):
    from syconn_tpu_torch.exec import exec_inference, exec_init, exec_skeleton
    from syconn_tpu_torch.handler.basics import clear_kd_cache
    from syconn_tpu_torch.skeleton.teasar import ROUTES, reset_routes

    clear_kd_cache()
    reset_routes()
    with port_wd(wd):
        exec_init.init_cell_subcell_sds(chunk_size=chunk, device="cpu")
        exec_init.run_create_rag()
        st3 = {}
        exec_inference.run_astrocyte_prediction_pts(device="cpu", stats=st3)
        split = exec_inference.run_astrocyte_splitting(device="cpu")
        st4 = {}
        exec_init.run_create_neuron_ssd(device="cpu", stats=st4)
        st5 = {}
        n = exec_skeleton.run_skeleton_generation(map_myelin=True, cube_size=chunk,
                                                  device="cpu", stats=st5)
    return split, n, st3, st4, st5, dict(ROUTES)


def _graph(path):
    from syconn_tpu_torch.io.graph import load_svgraph

    g = load_svgraph(path)
    return (set(int(n) for n in g["nodes"]),
            {tuple(sorted((int(a), int(b)))) for a, b in g["edges"]})


def _attr_dicts(d):
    from syconn_tpu_torch.backend import AttributeDict

    out = {}
    for p in sorted(glob.glob(os.path.join(d, "so_storage", "**", "attr_dict.pkl"),
                              recursive=True)):
        out.update(AttributeDict(p, read_only=True, disable_locking=True).copy_intern())
    return out


def _canonical(sk):
    """Node rows sorted (with the per-node values), edges as a set of
    endpoint-position pairs."""
    nodes = np.asarray(sk["nodes"], np.float64).reshape(-1, 3)
    cols = [nodes, np.asarray(sk["diameters"], np.float64)[:, None]]
    for key in ("myelin", "myelin_avg10000"):
        cols.append(np.asarray(sk[key], np.float64)[:, None])
    rows = np.concatenate(cols, axis=1)
    order = np.lexsort(rows.T[::-1])
    pos = [tuple(r) for r in nodes.tolist()]
    edges = {tuple(sorted((pos[a], pos[b]))) for a, b in np.asarray(sk["edges"]).reshape(-1, 2)}
    return rows[order], edges


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_steps_3_to_5_equal_jax(tmp_path, name):
    from syconn_tpu.reps.super_segmentation import SuperSegmentationDataset as JSSD
    from syconn_tpu.utils.testdata import generate_toy_world
    from syconn_tpu_torch.backend import SkeletonStorage
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset as TSSD

    spec = WORLDS[name]
    chunk = spec["chunk"]
    world = generate_toy_world(shape=spec["shape"], n_cells=spec["n_cells"],
                               svs_per_cell=spec["svs_per_cell"], seed=spec["seed"],
                               device=False)
    myelin = np.random.default_rng(7).integers(0, 256, spec["shape"], dtype=np.uint8)
    wj, wt = str(tmp_path / "jax"), str(tmp_path / "port")
    jcfg = _make_wd(wj, "jax", world, chunk, myelin)
    _make_wd(wt, "port", world, chunk, myelin)
    jsplit, jn = _run_jax(wj, chunk)
    tsplit, tn, st3, st4, st5, routes = _run_port(wt, chunk)

    # step 3: glia probabilities, then the split
    pj = np.load(os.path.join(wj, "svs_0", "glia_probass.npy"))
    pt = np.load(os.path.join(wt, "svs_0", "glia_probass.npy"))
    ids = np.load(os.path.join(wj, "svs_0", "ids.npy"))
    thresh = float(jcfg["glia"]["glia_thresh"])
    near = ids[np.abs(pj - thresh) < GLIA_ATOL].tolist()
    assert st3["contexts"] > 0 and st3["dispatches"] > 0
    np.testing.assert_allclose(pt, pj, rtol=0, atol=GLIA_ATOL)
    assert tsplit == jsplit, (tsplit, jsplit, f"SVs within {GLIA_ATOL} of glia_thresh: {near}")
    for g in ("pruned_svgraph.bz2", "neuron_svgraph.bz2", "astrocyte_svgraph.bz2"):
        assert _graph(os.path.join(wj, g)) == _graph(os.path.join(wt, g)), (g, near)
    assert jsplit["n_neuron_sv"] > 0

    # step 4: the SSD
    dj, dt = os.path.join(wj, "ssv_0"), os.path.join(wt, "ssv_0")
    npy = sorted(os.path.basename(p) for p in glob.glob(os.path.join(dj, "*.npy")))
    assert npy == sorted(os.path.basename(p) for p in glob.glob(os.path.join(dt, "*.npy")))
    for f in npy:
        _same(np.load(os.path.join(dj, f), allow_pickle=True),
              np.load(os.path.join(dt, f), allow_pickle=True), f)
    for f in ("mapping_dict.pkl",):
        with open(os.path.join(dj, f), "rb") as a, open(os.path.join(dt, f), "rb") as b:
            _same(pickle.load(a), pickle.load(b), f)
    aj, at = _attr_dicts(dj), _attr_dicts(dt)
    _same(aj, at, "ssv attr dicts")
    assert st4["cells"] == len(aj) > 0
    assert any(len(a.get("mapping_mi_ids", [])) for a in aj.values())
    assert any(len(a.get("mapping_vc_ids", [])) for a in aj.values())
    assert all("mi" in a and "vc" in a for a in aj.values())
    for ssv_id in aj:
        rel = os.path.relpath(glob.glob(os.path.join(dj, "so_storage", "**",
                                                     f"{ssv_id}_svgraph.pkl"),
                                        recursive=True)[0], dj)
        with open(os.path.join(dj, rel), "rb") as a, open(os.path.join(dt, rel), "rb") as b:
            ej, et = pickle.load(a), pickle.load(b)
        assert {tuple(sorted(e)) for e in ej} == {tuple(sorted(e)) for e in et}, ssv_id
    jssd, tssd = JSSD(working_dir=wj), TSSD(working_dir=wt)
    sv_ids = np.concatenate([np.asarray(a["sv_ids"], np.uint64) for a in aj.values()])
    assert np.array_equal(jssd.sv2ssv_ids(sv_ids), tssd.sv2ssv_ids(sv_ids))
    want = np.concatenate([np.full(len(a["sv_ids"]), k, np.uint64) for k, a in aj.items()])
    assert np.array_equal(tssd.sv2ssv_ids(sv_ids), want)
    assert os.path.isfile(os.path.join(dt, "sv2ssv.npz"))
    assert not os.path.exists(os.path.join(dt, "sv2ssv.h5"))

    # the cells' merged meshes, cable lengths and per-cell glia split
    for ssv_id in aj:
        a, b = jssd.get_super_segmentation_object(ssv_id), tssd.get_super_segmentation_object(
            ssv_id)
        for x, y in zip(a.load_mesh("sv"), b.load_mesh("sv")):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert a.total_edge_length() == b.total_edge_length() > 0
        ga, gb = a.gliasplit(), b.gliasplit()
        assert all(np.array_equal(x, y) for x, y in zip(ga, gb)), ssv_id

    # step 5: skeletons and myelin
    assert tn == jn == len(aj)
    assert routes["native"] > 0 and routes["python"] == 0, routes
    assert st5["cubes"] == int(np.prod(-(-np.asarray(spec["shape"]) // np.asarray(chunk))))
    n_myelin = 0
    for p in sorted(glob.glob(os.path.join(dj, "so_storage", "**", "skeletons.pkl"),
                              recursive=True)):
        sj = SkeletonStorage(p, read_only=True)
        stt = SkeletonStorage(os.path.join(dt, os.path.relpath(p, dj)), read_only=True)
        assert sorted(sj.keys()) == sorted(stt.keys())
        for k in sj.keys():
            a, b = sj[k], stt[k]
            assert sorted(a) == sorted(b), k
            ra, ea = _canonical(a)
            rb, eb = _canonical(b)
            assert np.array_equal(ra, rb), k
            assert ea == eb, k
            assert len(b["myelin"]) == len(b["nodes"])
            n_myelin += int(np.sum(b["myelin"]))
    assert n_myelin > 0
