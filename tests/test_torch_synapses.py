"""Steps 6 and 6.5 and the matrix export of the port against the JAX
package, through each package's working-directory configuration, on the
two-cell worlds of tests/test_synapses.py (two boxes with a 4-voxel gap and
an sj patch across it; an asymmetric and a symmetric variant): both packages
run steps 2, 4, 6 and 6.5 and the export from the same volumes in two
working directories and write

* the same ``syn_ssv`` and ``cs_ssv`` datasets: numpy caches, attribute
  dicts, voxel lists (row for row) and meshes;
* the same ``syn_ssv`` list in each cell's attribute dict, and ``syn_prob``;
* the same connectivity matrix: the CSV byte for byte, the NPZ arrays equal.

Stores are read through the port's readers. Also: the single-linkage
clustering of both packages on seeded point clouds whose gaps sit at the
linkage reach.
"""

import os

import numpy as np
import pytest
import torch

from _torch_helpers import _same, compare_datasets, jax_defaults_isolated, port_wd

SH = (96, 64, 48)
CHUNK = (64, 64, 64)
CONF = [("min_cc_size_ssv", 200), ("syntype_avail", True), ("process_cell_organelles", []),
        ("cell_objects", {"min_obj_vx": {"syn_ssv": 10, "cs": 10, "syn": 10}}),
        ("tpu", {"shard_pipeline": False})]  # both packages run their serial steps


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


def _world(variant):
    """tests/test_synapses.py's world: cells 7 and 9 with a 4-voxel gap at
    x in [46, 50), an sj patch spanning it, typed asymmetric or symmetric."""
    seg = np.zeros(SH, np.uint64)
    seg[4:46, 4:60, 4:44] = 7
    seg[50:92, 4:60, 4:44] = 9
    patch = (slice(42, 54), slice(20, 40), slice(10, 30))
    maps = {k: np.zeros(SH, np.uint8) for k in ("sj", "sym", "asym")}
    maps["sj"][patch] = 255
    maps[variant][patch] = 255
    return seg, maps


def _make_wd(wd, package, variant):
    if package == "jax":
        from syconn_tpu.handler.config import Config, generate_default_conf
        from syconn_tpu.io.chunked import ChunkedVolume
        from syconn_tpu.io.graph import save_svgraph
    else:
        from syconn_tpu_torch.handler.config import Config, generate_default_conf
        from syconn_tpu_torch.io.chunked import ChunkedVolume
        from syconn_tpu_torch.io.graph import save_svgraph
    generate_default_conf(wd, scaling=(10, 10, 20), key_value_pairs=CONF)
    cfg = Config(wd)
    seg, maps = _world(variant)
    ChunkedVolume.create(cfg.kd_seg_path, scale=(10, 10, 20), boundary=SH,
                         chunk_shape=CHUNK).save_seg(seg)
    for name, data in maps.items():
        ChunkedVolume.create(getattr(cfg, f"kd_{name}_path"), scale=(10, 10, 20), boundary=SH,
                             chunk_shape=CHUNK).save_raw(data)
    save_svgraph(np.zeros((0, 2), np.uint64), cfg.init_svgraph_path)


def _run_jax(wd):
    from syconn_tpu import global_params
    from syconn_tpu.exec import exec_init, exec_syns
    from syconn_tpu.handler.basics import clear_kd_cache

    clear_kd_cache()
    prev = global_params.wd
    global_params.wd = wd
    try:
        exec_init.init_cell_subcell_sds(chunk_size=CHUNK, overwrite=True)
        exec_init.run_create_rag()
        exec_init.run_create_neuron_ssd()
        stats = exec_syns.run_syn_generation(chunk_size=CHUNK)
        cs = exec_syns.run_cs_ssv_generation()
        csv = exec_syns.run_matrix_export()
    finally:
        global_params.wd = prev
    return stats, cs, csv


def _run_port(wd):
    from syconn_tpu_torch.exec import exec_init, exec_syns
    from syconn_tpu_torch.handler.basics import clear_kd_cache

    clear_kd_cache()
    with port_wd(wd):
        exec_init.init_cell_subcell_sds(chunk_size=CHUNK, overwrite=True, device="cpu")
        exec_init.run_create_rag()
        exec_init.run_create_neuron_ssd(device="cpu")
        stats = exec_syns.run_syn_generation(chunk_size=CHUNK, device="cpu")
        cs = exec_syns.run_cs_ssv_generation(device="cpu")
        csv = exec_syns.run_matrix_export(device="cpu")
    return stats, cs, csv


def _ssv_attrs(wd):
    import glob

    from syconn_tpu_torch.backend import AttributeDict

    out = {}
    for p in sorted(glob.glob(os.path.join(wd, "ssv_0", "so_storage", "**", "attr_dict.pkl"),
                              recursive=True)):
        out.update(AttributeDict(p, read_only=True, disable_locking=True).copy_intern())
    return out


@pytest.mark.parametrize("variant", ["asym", "sym"])
def test_steps_6_and_export_equal_jax(tmp_path, variant):
    wj, wt = str(tmp_path / "jax"), str(tmp_path / "port")
    _make_wd(wj, "jax", variant)
    _make_wd(wt, "port", variant)
    sj, csj, csvj = _run_jax(wj)
    st, cst, csvt = _run_port(wt)
    for k in ("n_cs", "n_syn", "n_syn_ssv"):
        assert st[k] == sj[k], k
    assert st["n_syn_ssv"] == 1 and cst["n_cs_ssv"] == csj["n_cs_ssv"] >= 1
    assert set(st["stages"]) >= {"extract_contact_sites", "combine_and_split_syn",
                                 "classify_synssv_objects", "map_synssv_objects"}
    compare_datasets(wj, wt, ["syn_ssv", "cs_ssv"])

    from syconn_tpu_torch.reps.segmentation import SegmentationDataset

    sd = SegmentationDataset("syn_ssv", working_dir=wt)
    assert sd.load_numpy_data("syn_sign").tolist() == ([1] if variant == "asym" else [-1])
    prob = sd.load_numpy_data("syn_prob")
    assert np.array_equal(prob, SegmentationDataset("syn_ssv", working_dir=wj).load_numpy_data(
        "syn_prob")) and 0 <= prob.min() and prob.max() <= 1
    aj, at = _ssv_attrs(wj), _ssv_attrs(wt)
    assert sorted(aj) == sorted(at) == [7, 9]
    for k in aj:
        _same(aj[k]["syn_ssv"], at[k]["syn_ssv"], f"ssv {k} syn_ssv")
        assert at[k]["syn_ssv"].tolist() == [1]
    assert os.path.relpath(csvt, wt) == os.path.relpath(csvj, wj)
    with open(csvj, "rb") as a, open(csvt, "rb") as b:
        assert a.read() == b.read()
    with np.load(csvj[:-4] + ".npz") as zj, np.load(csvt[:-4] + ".npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            _same(zj[k], zt[k], k)
    with open(csvt) as f:
        assert len(f.read().strip().split("\n")) == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_connected_cluster_kdtree_equal_jax(seed):
    """Clusters of random points, spaced so that some gaps fall just inside
    and some just outside the grid linkage's reach (the grid cell is gap/3:
    cells up to two apart join, so gaps between gap/3 and gap depend on the
    grid), labels equal."""
    from syconn_tpu.extraction.cs_processing import connected_cluster_kdtree as jfn
    from syconn_tpu_torch.extraction.cs_processing import connected_cluster_kdtree as tfn

    rng = np.random.default_rng(seed)
    gap = 250.0
    pts = []
    x = 0.0
    for _ in range(12):
        blob = rng.normal(0, 10, (int(rng.integers(5, 60)), 3)) + [x, 0, 0]
        pts.append(blob)
        x = blob[:, 0].max() + 30 + gap * rng.uniform(0.2, 1.8)
    coords = np.concatenate(pts)
    coords = coords[rng.permutation(len(coords))]
    lj, lt = jfn(coords, gap), tfn(coords, gap)
    assert lj.dtype == lt.dtype and np.array_equal(lj, lt)
    assert 1 < len(np.unique(lt)) < 12
    assert tfn(np.zeros((0, 3)), gap).shape == (0,)


def test_syn_agglomeration_resumes_from_the_step_cache(tmp_path):
    """``combine_and_split_syn(overwrite=False)`` takes a partner pair's
    clusters from ``<wd>/.stepcache/syn_agglomerate`` (an edited cache entry
    shows in the dataset) and recomputes a pair whose entry is gone;
    ``overwrite=True`` recomputes everything."""
    import pickle

    from syconn_tpu_torch.extraction.cs_processing import combine_and_split_syn
    from syconn_tpu_torch.reps.segmentation import SegmentationDataset

    wt = str(tmp_path / "port")
    _make_wd(wt, "port", "asym")
    _run_port(wt)
    entry = os.path.join(wt, ".stepcache", "syn_agglomerate", "7_9.pkl")
    assert os.path.isfile(os.path.join(os.path.dirname(entry), "__complete__"))
    with open(entry, "rb") as f:
        objs = pickle.load(f)
    size = objs[0]["size"]
    objs[0]["size"] = size + 1000
    with open(entry, "wb") as f:
        pickle.dump(objs, f)
    with port_wd(wt):
        def sizes(**kw):
            assert combine_and_split_syn(**kw)["n_syn_ssv"] == 1
            return SegmentationDataset("syn_ssv").load_numpy_data("size").tolist()

        assert sizes(overwrite=False) == [size + 1000]
        os.remove(entry)
        assert sizes(overwrite=False) == [size]
        assert os.path.isfile(entry)
        objs[0]["size"] = size + 1000
        with open(entry, "wb") as f:
            pickle.dump(objs, f)
        assert sizes(overwrite=True) == [size]


def test_classify_with_a_pickled_forest_equal_jax(tmp_path, monkeypatch):
    """Where ``mpath_syn_rfc`` holds a pickled random forest, both packages
    unpickle it and give the same ``syn_prob``; without scikit-learn the
    port's unpickling raises."""
    import pickle
    import sys

    from sklearn.ensemble import RandomForestClassifier

    from syconn_tpu import global_params as jparams
    from syconn_tpu.extraction.cs_processing import classify_synssv_objects as jclassify
    from syconn_tpu_torch.extraction.cs_processing import (classify_synssv_objects,
                                                           synssv_o_features)
    from syconn_tpu_torch.handler.config import Config
    from syconn_tpu_torch.reps.segmentation import SegmentationDataset

    rng = np.random.default_rng(0)
    feats = rng.normal(size=(64, 14))
    feats[:, 0] = rng.uniform(0, 5000, 64)  # size_vx
    rfc = RandomForestClassifier(n_estimators=5, max_depth=3, random_state=0).fit(
        feats, rng.integers(0, 2, 64))
    wj, wt = str(tmp_path / "jax"), str(tmp_path / "port")
    _make_wd(wj, "jax", "asym")
    _make_wd(wt, "port", "asym")
    _run_jax(wj)
    _run_port(wt)
    for w in (wj, wt):
        p = Config(w).mpath_syn_rfc
        assert p == os.path.join(w, "models", "syn_rfc.pkl")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            pickle.dump(rfc, f)
    prev = jparams.wd
    jparams.wd = wj
    try:
        jclassify()
    finally:
        jparams.wd = prev
    with port_wd(wt):
        classify_synssv_objects()
        got = SegmentationDataset("syn_ssv").load_numpy_data("syn_prob")
        monkeypatch.setitem(sys.modules, "sklearn", None)
        with pytest.raises(ImportError):
            classify_synssv_objects()
    want = SegmentationDataset("syn_ssv", working_dir=wj).load_numpy_data("syn_prob")
    assert np.array_equal(got, want)
    sd = SegmentationDataset("syn_ssv", working_dir=wt)
    assert np.array_equal(got, rfc.predict_proba(synssv_o_features(sd))[:, 1])


def test_create_syn_rfc_equals_jax(tmp_path, monkeypatch):
    """Both packages' ``create_syn_rfc`` fit on the same seeded features and
    labels: every tree of the two pickles is equal, and so is
    ``predict_proba``; with the port's pickle in ``mpath_syn_rfc`` the
    port's ``classify_synssv_objects`` writes the ``syn_prob`` of the JAX
    package's with its own pickle. Without scikit-learn the port's trainer
    raises ``ImportError``. The forests predict with ``n_jobs=-1``, whose
    threads add the trees' probabilities in the order they finish, so the
    predictions run under joblib's sequential backend (trees in order)."""
    import pickle
    import sys

    from joblib import parallel_backend

    from syconn_tpu import global_params as jparams
    from syconn_tpu.extraction.cs_processing import classify_synssv_objects as jclassify
    from syconn_tpu.extraction.cs_processing import create_syn_rfc as jcreate
    from syconn_tpu_torch.extraction.cs_processing import (classify_synssv_objects,
                                                           create_syn_rfc)
    from syconn_tpu_torch.handler.config import Config
    from syconn_tpu_torch.reps.segmentation import SegmentationDataset

    rng = np.random.default_rng(4)
    feats = rng.normal(size=(96, 14))
    feats[:, 0] = rng.uniform(0, 5000, 96)  # size_vx
    labels = (feats[:, 0] + 800 * feats[:, 2] > 2500).astype(np.int64)
    wj, wt = str(tmp_path / "jax"), str(tmp_path / "port")
    _make_wd(wj, "jax", "asym")
    _make_wd(wt, "port", "asym")
    _run_jax(wj)
    _run_port(wt)
    jrfc = jcreate(feats, labels, save_path=Config(wj).mpath_syn_rfc)
    trfc = create_syn_rfc(feats, labels, save_path=Config(wt).mpath_syn_rfc)
    probe = rng.normal(size=(64, 14))
    probe[:, 0] = rng.uniform(0, 5000, 64)
    pickled = []
    for w in (wj, wt):
        with open(Config(w).mpath_syn_rfc, "rb") as f:
            pickled.append(pickle.load(f))
    for rfc in [trfc] + pickled:
        assert len(rfc.estimators_) == len(jrfc.estimators_) == 200
        for a, b in zip(rfc.estimators_, jrfc.estimators_):
            for key in ("feature", "threshold", "children_left", "value"):
                assert np.array_equal(getattr(a.tree_, key), getattr(b.tree_, key))
    with parallel_backend("sequential"):
        want = jrfc.predict_proba(probe)
        assert 0.0 < want[:, 1].min() < want[:, 1].max() < 1.0
        for rfc in [trfc] + pickled:
            assert np.array_equal(rfc.predict_proba(probe), want)
        prev = jparams.wd
        jparams.wd = wj
        try:
            jclassify()
        finally:
            jparams.wd = prev
        with port_wd(wt):
            classify_synssv_objects()
            got = SegmentationDataset("syn_ssv").load_numpy_data("syn_prob")
    assert np.array_equal(got, SegmentationDataset("syn_ssv", working_dir=wj)
                          .load_numpy_data("syn_prob"))
    for name in ("sklearn", "sklearn.ensemble"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        create_syn_rfc(feats, labels)
