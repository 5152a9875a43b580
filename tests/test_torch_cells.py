"""Steps 3-9 of the port against the JAX package, through each package's
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
  positions);
* from the same worlds with their sj/sym/asym maps, steps 6-9 and the export
  (``test_steps_6_to_9_equal_jax``): the same ``syn_ssv``/``cs_ssv``
  datasets, labels and matrix, the nets' float outputs within ``NET_ATOL``.

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

from _torch_helpers import _same, compare_datasets, jax_defaults_isolated, port_wd

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
# steps 6-9 (test_steps_6_to_9_equal_jax): synapse types from the sym/asym
# maps, and no size threshold on the organelles a cell keeps, so that the
# toy worlds' small mi and vc reach the synapse mapping
CONF_SYN = [(k, v) for k, v in CONF if k != "cell_objects"] + [
    ("syntype_avail", True),
    ("cell_objects", dict(dict(CONF)["cell_objects"], sizethresholds={"mi": 0, "vc": 0}))]
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


def _make_wd(wd, package, world, chunk, myelin, syn_maps=False):
    if package == "jax":
        from syconn_tpu.handler.config import Config, generate_default_conf
        from syconn_tpu.io.chunked import ChunkedVolume
    else:
        from syconn_tpu_torch.handler.config import Config, generate_default_conf
        from syconn_tpu_torch.io.chunked import ChunkedVolume
    generate_default_conf(wd, scaling=(10, 10, 20), key_value_pairs=CONF_SYN if syn_maps else CONF)
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
    for name in ("sj", "sym", "asym") if syn_maps else ():
        ChunkedVolume.create(getattr(cfg, f"kd_{name}_path"), scale=(10, 10, 20), boundary=sh,
                             chunk_shape=chunk).save_raw(world[name])
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


# --------------------------------------------------------------- steps 6-9
def _run_jax_6_to_9(wd, chunk):
    """Steps 2-9 and the export of the JAX package, as start.py runs them;
    the point-net steps (3, 7, 8, 9) under ``jax.disable_jit()``, so that
    the nets run as flax's eager ``apply``, which the port follows."""
    import jax

    from syconn_tpu import global_params
    from syconn_tpu.exec import exec_inference, exec_init, exec_skeleton, exec_syns
    from syconn_tpu.handler.basics import clear_kd_cache

    clear_kd_cache()
    prev = global_params.wd
    global_params.wd = wd
    try:
        exec_init.init_cell_subcell_sds(chunk_size=chunk)
        exec_init.run_create_rag()
        with jax.disable_jit():
            exec_inference.run_astrocyte_prediction_pts()
        exec_inference.run_astrocyte_splitting()
        exec_init.run_create_neuron_ssd()
        exec_skeleton.run_skeleton_generation(map_myelin=True, cube_size=chunk)
        syn = exec_syns.run_syn_generation(chunk_size=chunk)
        cs = exec_syns.run_cs_ssv_generation()
        with jax.disable_jit():
            exec_inference.run_semsegaxoness_prediction()
            exec_inference.run_semsegspiness_prediction()
        shv = exec_syns.run_spinehead_volume_calc()
        with jax.disable_jit():
            exec_inference.run_morphology_embedding()
            exec_inference.run_celltype_prediction()
        csv = exec_syns.run_matrix_export()
    finally:
        global_params.wd = prev
    return syn, cs, shv, csv


def _run_port_6_to_9(wd, chunk):
    from syconn_tpu_torch.exec import exec_inference, exec_init, exec_skeleton, exec_syns
    from syconn_tpu_torch.handler.basics import clear_kd_cache

    clear_kd_cache()
    st = {}
    with port_wd(wd):
        exec_init.init_cell_subcell_sds(chunk_size=chunk, device="cpu")
        exec_init.run_create_rag()
        exec_inference.run_astrocyte_prediction_pts(device="cpu")
        exec_inference.run_astrocyte_splitting(device="cpu")
        exec_init.run_create_neuron_ssd(device="cpu")
        exec_skeleton.run_skeleton_generation(map_myelin=True, cube_size=chunk, device="cpu")
        syn = exec_syns.run_syn_generation(chunk_size=chunk, device="cpu")
        cs = exec_syns.run_cs_ssv_generation(device="cpu")
        for name, fn in (("axoness", exec_inference.run_semsegaxoness_prediction),
                         ("spiness", exec_inference.run_semsegspiness_prediction)):
            st[name] = {}
            fn(device="cpu", stats=st[name])
        st["spinehead"] = {}
        shv = exec_syns.run_spinehead_volume_calc(device="cpu", stats=st["spinehead"])
        for name, fn in (("embedding", exec_inference.run_morphology_embedding),
                         ("celltype", exec_inference.run_celltype_prediction)):
            st[name] = {}
            fn(device="cpu", stats=st[name])
        csv = exec_syns.run_matrix_export(device="cpu")
    return syn, cs, shv, csv, st


# float outputs of the nets. With the JAX package's point-net steps under
# jax.disable_jit() every label (axoness and spiness per vertex and node,
# cell types) equals the port's; the floats differ at f32 accumulation
# level: per-context celltype logits (magnitude ~5, 12 global scalars) by at
# most 2.2e-3, certainties by 1.6e-5, embeddings by 5.7e-6 on these worlds
NET_ATOL = {"celltype_cnn_e3_probas": 5e-3, "celltype_cnn_e3_certainty": 1e-4,
            "latent_morph": 1e-4}


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_steps_6_to_9_equal_jax(tmp_path, name):
    """Steps 6-9 and the export on the same worlds (steps 2-5 as above, with
    the sj/sym/asym maps): ``syn_ssv`` and ``cs_ssv`` datasets (organelle
    mapping features, ``syn_prob``, ``spinehead_vol``, partner properties),
    the cells' attribute dicts and skeletons (axoness and spiness per node
    and per vertex, cell types, synapse lists) and the matrix equal the JAX
    package's exactly, the nets' float outputs within ``NET_ATOL``."""
    from syconn_tpu.utils.testdata import generate_toy_world
    from syconn_tpu_torch.backend import SkeletonStorage

    spec = WORLDS[name]
    chunk = spec["chunk"]
    world = generate_toy_world(shape=spec["shape"], n_cells=spec["n_cells"],
                               svs_per_cell=spec["svs_per_cell"], seed=spec["seed"],
                               device=False)
    myelin = np.random.default_rng(7).integers(0, 256, spec["shape"], dtype=np.uint8)
    wj, wt = str(tmp_path / "jax"), str(tmp_path / "port")
    jcfg = _make_wd(wj, "jax", world, chunk, myelin, syn_maps=True)
    _make_wd(wt, "port", world, chunk, myelin, syn_maps=True)
    synj, csj, shvj, csvj = _run_jax_6_to_9(wj, chunk)
    synt, cst, shvt, csvt, st = _run_port_6_to_9(wt, chunk)

    # steps 6 and 6.5
    assert {k: synt[k] for k in synj} == synj and cst == {**csj, "n_pairs": cst["n_pairs"]}
    assert synt["n_syn_ssv"] > 0 and cst["n_cs_ssv"] > 0
    compare_datasets(wj, wt, ["syn_ssv", "cs_ssv"])
    assert np.array_equal(shvj, shvt)
    syn_dir = os.path.join(wt, "syn_ssvs_0")
    feats = [np.load(os.path.join(syn_dir, f"n_{co}_vxs_{j}s.npy")) for co in ("mi", "vc")
             for j in (0, 1)]
    assert any(f.sum() > 0 for f in feats), "no organelle mapped to any synapse"

    # steps 7-9: cell attribute dicts and skeletons
    dj, dt = os.path.join(wj, "ssv_0"), os.path.join(wt, "ssv_0")
    aj, at = _attr_dicts(dj), _attr_dicts(dt)
    assert sorted(aj) == sorted(at)
    n_cells = len(at)
    for k in aj:
        for key, atol in NET_ATOL.items():
            np.testing.assert_allclose(np.asarray(at[k][key], np.float64),
                                       np.asarray(aj[k][key], np.float64), rtol=0, atol=atol,
                                       err_msg=f"{k}/{key}")
        _same({x: v for x, v in aj[k].items() if x not in NET_ATOL},
              {x: v for x, v in at[k].items() if x not in NET_ATOL}, f"ssv {k}")
        assert 0 <= at[k]["celltype_cnn_e3"] < 8
        assert at[k]["latent_morph"].shape == (int(jcfg["tcmn"]["ndim_embedding"]),)
    assert st["celltype"]["predicted"] == st["embedding"]["predicted"] == n_cells
    assert st["axoness"]["contexts"] > 0 and st["spiness"]["dispatches"] > 0
    for p in sorted(glob.glob(os.path.join(dj, "so_storage", "**", "skeletons.pkl"),
                              recursive=True)):
        sj = SkeletonStorage(p, read_only=True)
        stt = SkeletonStorage(os.path.join(dt, os.path.relpath(p, dj)), read_only=True)
        for k in sj.keys():
            _same(dict(sj[k]), dict(stt[k]), f"skeleton {k}")
            for key in ("axoness", "axoness_avg10000", "spiness", "spiness_avg10000"):
                assert len(stt[k][key]) == len(stt[k]["nodes"]), (k, key)
    for f in ("celltype_cnn_e3s.npy",):
        _same(np.load(os.path.join(dj, f)), np.load(os.path.join(dt, f)), f)

    # the export
    with open(csvj, "rb") as a, open(csvt, "rb") as b:
        assert a.read() == b.read()
    with np.load(csvj[:-4] + ".npz") as zj, np.load(csvt[:-4] + ".npz") as zt:
        for k in zj.files:
            _same(zj[k], zt[k], k)

    # the cell methods of steps 7-9 on the written cells
    from syconn_tpu.reps.super_segmentation import SuperSegmentationDataset as JSSD
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset as TSSD

    jssd, tssd = JSSD(working_dir=wj), TSSD(working_dir=wt)
    syn_rc = np.load(os.path.join(wt, "syn_ssvs_0", "rep_coords.npy"))
    for k in aj:
        a, b = jssd.get_super_segmentation_object(k), tssd.get_super_segmentation_object(k)
        for meth, args in (("axoness_for_coords", (syn_rc,)), ("shortestpath2soma", (syn_rc,)),
                           ("get_spine_compartments", ()), ("compartmentalize_mesh", ())):
            _same(getattr(a, meth)(*args), getattr(b, meth)(*args), f"ssv {k} {meth}")
        sa, sb = a.syn_sign_ratio(), b.syn_sign_ratio()
        assert sa == sb or (np.isnan(sa) and np.isnan(sb)), k
