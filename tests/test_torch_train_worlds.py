"""The port's training data from processed working directories against the
JAX package: a neuron world (``generate_neuron_world``) written into two
working directories, each package running steps 2, 4 and 5 on its own
(the view world's recipe of ``tests/test_torch_views.py``), with the
construction ground truth saved as ``neuron_gt.npz`` as
``examples/start.py`` saves it. Then, each package on its own directory:

* ``pipeline_cloud_pools`` (all pools, the compartment and hybrid celltype
  geometries included), ``harvest_view_pools`` and the batches of
  ``CellCloudData``, ``TripletCloudData`` and ``ViewData``: equal;
* ``ssv_to_cell`` and the scores of ``utils/quality_metrics.py`` that this
  directory can give (cell types, compartments, myelin): equal;
* ``eval_toy_point_models`` with the packaged point nets copied into both
  directories (the JAX side under ``jax.disable_jit()``, eager as the port):
  the accuracies within 0.02 (a bf16 flip can move a point's label);
* ``quality_pipeline_argv`` equals the JAX package's driver arguments, and
  ``run_quality_pipeline`` without a card raises before starting anything;
* the CLIs ``train_points``, ``train_views`` (on a copy of the port's
  directory as a ``seed<N>`` pipeline world), ``train_dense`` and
  ``train_pretrained`` (with one pipeline world from the port's driver) at
  toy sizes on the CPU: each writes its models into its working directory
  and nothing into the packaged weights; ``eval_quality`` scores the
  pipeline world;
* ``train_toy_point_models`` with these reconstruction pools (the hybrid
  celltype head, glia, the compartment geometry, tnet), the port from the
  JAX trainer's initial params: batches and class weights equal, the first
  two steps' losses within 1e-2 relative (``tests/test_torch_trainers.py``).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from _torch_helpers import port_wd

jax = pytest.importorskip("jax")

from test_torch_trainers import _same  # noqa: E402
from test_torch_views import _build_jax, _build_port, _JaxWd  # noqa: E402

CONF = [("min_cc_size_ssv", 200), ("use_point_models", False), ("process_cell_organelles", []),
        ("skeleton", {"kimimaro_skelgen": {"dust_threshold": 100},
                      "kimimaro_merge": {"dust_threshold": 100, "tick_threshold": 200}}),
        ("views", {"allow_untrained_models": True})]
EVAL_ATOL = 0.02


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _save_gt(wd, world):
    """``examples/start.py``'s ``neuron_gt.npz``."""
    sv_ids = np.asarray(sorted(world["sv2cell"]), np.uint64)
    syn = world["syn_gt"]
    np.savez_compressed(
        os.path.join(wd, "neuron_gt.npz"),
        celltype_gt=world["celltype_gt"], compart=world["compart"],
        spiness=world["spiness"], myelin=world["myelin"], sv_ids=sv_ids,
        sv_cells=np.asarray([world["sv2cell"][int(s)] for s in sv_ids], np.int64),
        syn_coords=np.asarray([s["coord_vx"] for s in syn], np.float64).reshape(-1, 3),
        syn_pre=np.asarray([s["pre_cell"] for s in syn], np.int64),
        syn_post=np.asarray([s["post_cell"] for s in syn], np.int64),
        syn_sign=np.asarray([1 if s["sign"] == "asym" else -1 for s in syn], np.int8),
        syn_on_spine=np.asarray([s["on_spine"] for s in syn], bool),
        syn_head_vol=np.asarray([s["head_vol_vx"] for s in syn], np.float64))


@pytest.fixture(scope="module")
def wds(tmp_path_factory):
    """(world, JAX working directory, port working directory)."""
    from syconn_tpu_torch.utils.testdata_neuro import generate_neuron_world

    base = tmp_path_factory.mktemp("train_worlds")
    wj, wt = str(base / "jax"), str(base / "torch")
    world = generate_neuron_world(shape=(96, 96, 48), n_cells=3, seed=2)
    _build_jax(wj, CONF, world)
    _build_port(wt, CONF, world)
    for wd in (wj, wt):
        _save_gt(wd, world)
    return world, wj, wt


def test_pipeline_cloud_pools_equal_jax(wds):
    from syconn_tpu.cnn.toy_points import pipeline_cloud_pools as J
    from syconn_tpu_torch.cnn.toy_points import pipeline_cloud_pools as T

    _, wj, wt = wds
    kw = dict(npoints=256, n_contexts=3, seed=3, spiness_npoints=64,
              comp_geom=(128, 4000.0), ct_geom=(128, 3200.0))
    ref = J(wj, **kw)
    with port_wd(None):
        got = T(wt, **kw)
    assert len(got) == 6 and len(got[0]) > 0
    _same(ref, got)


def test_cloud_batches_equal_jax(wds):
    from syconn_tpu.models.traindata import CellCloudData as JC, TripletCloudData as JTr
    from syconn_tpu.reps.super_segmentation import SuperSegmentationDataset as JS
    from syconn_tpu_torch.models.traindata import CellCloudData as TC, TripletCloudData as TTr
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset as TS

    _, wj, wt = wds
    sj, st = JS(working_dir=wj), TS(working_dir=wt)
    assert sorted(int(i) for i in sj.ssv_ids) == sorted(int(i) for i in st.ssv_ids)
    label_of = lambda i: int(i) % 3  # noqa: E731
    kw = dict(label_of=label_of, npoints=128, ctx_size_nm=8000.0, batch_size=3, seed=2)
    for J, T in ((JC, TC), (JTr, TTr)):
        ij, it = iter(J(ssd=sj, **kw)), iter(T(ssd=st, **kw))
        for _ in range(2):
            _same(next(ij), next(it))


def test_view_pools_and_batches_equal_jax(wds):
    from syconn_tpu.cnn.train_views import harvest_view_pools as JH
    from syconn_tpu.models.traindata import ViewData as JV
    from syconn_tpu.reps.super_segmentation import SuperSegmentationDataset as JS
    from syconn_tpu_torch.cnn.train_views import harvest_view_pools as TH
    from syconn_tpu_torch.models.traindata import ViewData as TV
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset as TS

    _, wj, wt = wds
    ref = JH([wj])
    with port_wd(None):
        got = TH([wt], device="cpu")
    assert got[0].dtype == np.uint8 and got[0].ndim == 5 and len(got[0]) == len(got[1]) > 0
    _same(ref, got)
    kw = dict(label_of=lambda i: int(i) % 4, batch_size=3, seed=5)
    with _JaxWd(wj):
        bj = [next(iter(JV(ssd=JS(working_dir=wj), **kw)))]
    with port_wd(wt):
        bt = [next(iter(TV(ssd=TS(working_dir=wt), device="cpu", **kw)))]
    _same(bj, bt)


def test_quality_scores_equal_jax(wds, monkeypatch):
    from syconn_tpu.reps.super_segmentation import SuperSegmentationDataset as JS
    from syconn_tpu.utils import quality_metrics as J
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset as TS
    from syconn_tpu_torch.utils import quality_metrics as T

    _, wj, wt = wds
    gt = np.load(os.path.join(wj, "neuron_gt.npz"))
    cj = {int(i): J.ssv_to_cell(JS(working_dir=wj).get_super_segmentation_object(int(i)), gt)
          for i in JS(working_dir=wj).ssv_ids}
    ct = {int(i): T.ssv_to_cell(TS(working_dir=wt).get_super_segmentation_object(int(i)), gt)
          for i in TS(working_dir=wt).ssv_ids}
    assert cj == ct and max(ct.values()) > 0
    from syconn_tpu import global_params as jgp

    prev = jgp.wd
    try:
        ref = {f.__name__: f(wj, gt) for f in (J.score_celltype, J.score_compartments,
                                                  J.score_myelin)}
    finally:
        jgp.wd = prev
    with port_wd(None):
        got = {f.__name__: f(wt, gt) for f in (T.score_celltype, T.score_compartments,
                                                  T.score_myelin)}
    for k in ref:
        assert ref[k].keys() == got[k].keys()
        for m in ref[k]:
            assert (np.isnan(ref[k][m]) and np.isnan(got[k][m])) or ref[k][m] == got[k][m], (k, m)

    # the fixture's arguments are the JAX package's; without a card no run starts
    import subprocess

    calls = []

    def record(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(subprocess, "run", record)
    J.run_quality_pipeline(wt, 777)
    J.run_quality_pipeline(wt, 5, shape=(64, 64, 32), n_cells=4)
    assert calls[0][1].endswith(os.path.join("examples", "start.py"))
    assert calls[0][2:] == T.quality_pipeline_argv(wt, 777)
    assert calls[1][2:] == T.quality_pipeline_argv(wt, 5, (64, 64, 32), 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.run_quality_pipeline(wt, 0)
    assert len(calls) == 2


def test_eval_point_models_matches_jax(wds):
    from syconn_tpu.cnn import toy_points as JP
    from syconn_tpu_torch.cnn import toy_points as TP
    from syconn_tpu_torch.models.io import packaged_model_path
    from syconn_tpu_torch.utils.testdata_neuro import generate_neuron_world

    _, wj, wt = wds
    for name in ("compartment_pts", "glia_pts"):
        for wd in (wj, wt):
            dst = os.path.join(wd, "models", name)
            if not os.path.isdir(dst):
                shutil.copytree(packaged_model_path(name), dst)
    held = generate_neuron_world(shape=(64, 64, 32), n_cells=3, seed=9)
    with _JaxWd(wj), jax.disable_jit():
        ref = JP.eval_toy_point_models(held, npoints=256)
    with port_wd(wt):
        got = TP.eval_toy_point_models(held, npoints=256, device="cpu")
    assert sorted(got) == sorted(ref) and "compartment_acc" in got
    assert "celltype_acc" not in got  # no celltype net in the working directory
    for k in ref:
        assert abs(got[k] - ref[k]) <= EVAL_ATOL, (k, got[k], ref[k])


def test_point_trainer_on_pipeline_pools_equal_jax(wds, tmp_path, monkeypatch):
    from syconn_tpu import global_params as jparams
    from syconn_tpu.cnn import toy_points as JP
    from syconn_tpu.models import train as JM
    from syconn_tpu_torch.cnn import toy_points as TP
    from syconn_tpu_torch.handler.config import generate_default_conf
    from syconn_tpu_torch.models import train as TM
    from test_torch_trainers import FIRST_LOSS_RTOL, _compare_runs, _jax_wd, _Recorder

    world, wj, wt = wds
    geo = dict(comp_geom=(128, 4000.0), ct_geom=(128, 3200.0))
    pool_kw = dict(npoints=128, n_contexts=3, seed=3, spiness_npoints=64, **geo)
    kw = dict(tasks=("celltype", "glia", "compartment", "tnet"), steps=2, npoints=128, batch=3,
              **geo)
    prev = jparams.wd
    try:
        pools_j = JP.pipeline_cloud_pools(wj, **pool_kw)
        _jax_wd(str(tmp_path / "jax"))
        rj = _Recorder(monkeypatch, JM, port=False)
        mj = JP.train_toy_point_models([world], extra_pools=pools_j, **kw)
    finally:
        jparams.wd = prev
    with port_wd(None):
        pools_t = TP.pipeline_cloud_pools(wt, **pool_kw)
    generate_default_conf(str(tmp_path / "torch"), scaling=(10, 10, 20))
    rt = _Recorder(monkeypatch, TM, port=True, inits=list(rj.inits))
    with port_wd(str(tmp_path / "torch")):
        mt = TP.train_toy_point_models([world], extra_pools=pools_t, device="cpu", **kw)
    assert sorted(mt) == sorted(mj) == ["celltype", "compartment", "glia", "tnet_loss"]
    rel = _compare_runs(rj, rt)
    assert len(rt.batches) == 8 and len(rt.weights) == 1
    assert rt.batches[0][0].shape == (3, 128, 7 + 12)  # the hybrid head's global scalars
    assert len(rt.batches[6]) == 3  # triplets
    for i in range(0, 8, 2):  # the first two steps of each task
        assert rel[i] < FIRST_LOSS_RTOL and rel[i + 1] < FIRST_LOSS_RTOL, rel
    import json

    for name in ("celltype_pts", "glia_pts", "compartment_pts", "tnet_pts"):
        aj = json.load(open(tmp_path / "jax" / "models" / name / "arch.json"))
        at = json.load(open(tmp_path / "torch" / "models" / name / "arch.json"))
        assert at["cls"] == aj["cls"] and at["kwargs"] == aj["kwargs"]
        assert at["meta"] == aj["meta"], name


def test_training_clis_write_the_working_directory(wds, tmp_path, monkeypatch):
    import json

    from syconn_tpu_torch.cnn import train_dense, train_points, train_pretrained, train_views
    from syconn_tpu_torch.handler.config import generate_default_conf
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.models.io import load_model_meta
    from test_torch_trainers import _packaged_bytes

    world, _, wt = wds
    packaged = _packaged_bytes()
    wd = str(tmp_path / "points")
    shutil.copytree(wt, wd)
    with port_wd(None):
        train_points.main(["--task", "celltype", "--wd", wd, "--steps", "2", "--npoints", "64",
                           "--batch", "2", "--device", "cpu"])
        train_points.main(["--task", "tnet", "--wd", wd, "--steps", "1", "--npoints", "64",
                           "--batch", "2", "--device", "cpu"])
    assert load_model_meta(os.path.join(wd, "models", "celltype_pts")) == {"task": "celltype"}
    assert load_model_meta(os.path.join(wd, "models", "tnet_pts")) == {"task": "tnet"}

    shutil.copytree(wt, tmp_path / "pipe" / "seed5")
    report = str(tmp_path / "views.json")
    with port_wd(None):
        train_views.main(["--pipe_dir", str(tmp_path / "pipe"), "--n_worlds", "1", "--steps",
                          "2", "--out", report, "--device", "cpu"])
    rep = json.load(open(report))
    assert rep["n_stacks"] > 0 and rep["steps"] == 2

    wd = str(tmp_path / "dense")
    generate_default_conf(wd, scaling=(10, 10, 20))
    with port_wd(wd) as cfg:
        kd = ChunkedVolume.create(cfg.kd_seg_path, scale=(10, 10, 20), boundary=world["raw"].shape)
        kd.save_raw(world["raw"])
        gt = str(tmp_path / "gt")
        ChunkedVolume.create(gt, scale=(10, 10, 20), boundary=world["raw"].shape).save_seg(
            (world["myelin"] > 0).astype(np.uint64))
    with port_wd(None):
        train_dense.main(["--task", "myelin", "--wd", wd, "--gt_kd", gt, "--steps", "2",
                          "--tile", "32", "32", "16", "--device", "cpu"])
    assert load_model_meta(os.path.join(wd, "models", "myelin")) == {"task": "myelin", "steps": 2}

    # one pipeline world (training seed 0) through the port's driver in a
    # subprocess, at 40x40x20: the smallest of 32/40/48 voxels across whose
    # neuron world leaves cells to harvest (2; none at 32x32x16)
    from syconn_tpu_torch.cnn import toy_points

    wd, pipe = str(tmp_path / "pretrained"), str(tmp_path / "pipe_worlds")
    seen = []
    trainer = toy_points.train_toy_point_models

    def record(*a, **kw):
        seen.append(kw["extra_pools"])
        return trainer(*a, **kw)

    monkeypatch.setattr(toy_points, "train_toy_point_models", record)
    with port_wd(None):
        train_pretrained.main(["--wd", wd, "--n_worlds", "1", "--shape", "40", "40", "20",
                               "--n_cells", "3", "--steps_dense", "1", "--steps_pts", "1",
                               "--dense_tasks", "myelin", "--pts_tasks", "glia",
                               "--pipeline_worlds", "1", "--pipe_dir", pipe,
                               "--device", "cpu"])
    rep = json.load(open(os.path.join(wd, "train_report.json")))
    assert "myelin_myelin_iou" in rep["dense_heldout_iou"] and "glia" in rep["pts_train"]
    assert os.path.isfile(os.path.join(pipe, "seed0", "neuron_gt.npz"))
    assert os.path.isfile(os.path.join(pipe, "seed0", "connectivity_matrix", "conn_mat.csv"))
    assert len(seen) == 1 and len(seen[0][0]) >= 1  # the harvested cells reach the trainer
    assert _packaged_bytes() == packaged

    # eval_quality scores that pipeline world and writes its report
    from syconn_tpu_torch.cnn import eval_quality

    with port_wd(None):
        eval_quality.main(["--keep_wd", pipe, "--seeds", "0", "--skip_run", "--device", "cpu"])
    rep = json.load(open(os.path.join(pipe, "quality_report.json")))
    assert rep["seeds"] == [0] and sorted(rep["mean"]) == sorted(rep["per_seed"]["0"]) == [
        "celltype", "celltype_views", "compartments", "myelin", "spinehead", "synapses"]
