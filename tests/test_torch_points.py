"""The array level of the port's point inference
(``syconn_tpu_torch/inference/points.py``) against the JAX package on the
CPU: ``extract_contexts`` (surface-sampled centres, random centres, given
centres, padding, empty clouds), ``certainty_estimate`` and
``append_global_scalars`` equal exactly; ``ContextPipeline`` on the cases
of tests/test_points_pipeline.py (batching across items, empty items)
gives the same outputs, dispatches and rows; ``ContextPredictor`` pads
short batches and needs the card unless asked for the CPU; so do the
predictions of steps 7-9, which run on a one-cell working directory."""

import os

import numpy as np
import pytest
import torch

from syconn_tpu_torch.inference import points as tpoints

jpoints = pytest.importorskip("syconn_tpu.inference.points")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    coords = (rng.random((n, 3)) * np.array([20000, 15000, 9000])).astype(np.float32)
    types = rng.integers(0, 4, n).astype(np.int32)
    return coords, types


@pytest.mark.parametrize("case", ["surface", "n_contexts", "centers", "padded", "few_types",
                                  "empty"])
def test_extract_contexts_equal_jax(case):
    coords, types = _cloud(4000, 3)
    kw = dict(ctx_size_nm=6000.0, npoints=256)
    if case == "n_contexts":
        kw["n_contexts"] = 7
    elif case == "centers":
        kw["centers_nm"] = coords[[5, 100, 2000]] + 50.0
    elif case == "padded":
        coords, types = coords[:300], types[:300]
        kw["npoints"] = 1024
    elif case == "few_types":
        types = np.full(len(types), 2, np.int32)  # no cell surface: all points are centres
    elif case == "empty":
        coords, types = coords[:0], types[:0]
    ref, ref_ix = jpoints.extract_contexts(coords, types, rng=np.random.default_rng(9), **kw)
    got, got_ix = tpoints.extract_contexts(coords, types, rng=np.random.default_rng(9), **kw)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert len(got_ix) == len(ref_ix)
    for a, b in zip(got_ix, ref_ix):
        np.testing.assert_array_equal(a, b)
    if case != "empty":
        assert len(got) > 0
    if case == "padded":
        assert all(len(np.unique(ix)) < 1024 for ix in got_ix)


def test_certainty_and_global_scalars_equal_jax():
    rng = np.random.default_rng(1)
    for logits in (rng.normal(size=8) * 4, rng.normal(size=(5, 3)), np.array([100.0, 0, 0]),
                   np.ones(4)):
        assert tpoints.certainty_estimate(logits) == jpoints.certainty_estimate(logits)
    probs = rng.random(6)
    assert tpoints.certainty_estimate(probs, is_logit=False) == \
        jpoints.certainty_estimate(probs, is_logit=False)
    ctx = rng.normal(size=(3, 64, 7)).astype(np.float32)
    s = rng.normal(size=12).astype(np.float32)
    norm = (rng.normal(size=12).astype(np.float32), rng.random(12).astype(np.float32) + 0.5)
    for nm in (None, norm):
        np.testing.assert_array_equal(tpoints.append_global_scalars(ctx, s, nm),
                                      jpoints.append_global_scalars(ctx, s, nm))


class _CountingPredictor:
    """ContextPredictor stand-in that records batch occupancy
    (tests/test_points_pipeline.py)."""

    def __init__(self, batch=16):
        self.batch = batch
        self.dispatched = []

    def dispatch(self, chunk):
        self.dispatched.append(len(chunk))
        if len(chunk) < self.batch:
            pad = np.zeros((self.batch - len(chunk),) + chunk.shape[1:], chunk.dtype)
            chunk = np.concatenate([chunk, pad])
        return {"logits": chunk[:, :, 0].mean(axis=1, keepdims=True)}

    def fetch(self, dev):
        return dev


def _run_pipeline(module, items, ctx_of, batch, **kw):
    pred = _CountingPredictor(batch=batch)
    pipe = module.ContextPipeline(pred, **kw)
    got = {}

    def load(i):
        c = ctx_of.get(i)
        return (c, None) if c is not None else (None, f"aux{i}")

    def post(i, out, aux):
        got[i] = (None if out is None else out["logits"][:, 0], aux)
        return 1

    n = sum(pipe.run(items, load, post))
    return n, got, pipe, pred


@pytest.mark.parametrize("case", ["across_items", "empty_items"])
def test_context_pipeline_equals_jax(case):
    rng = np.random.default_rng(0)
    if case == "across_items":
        items, batch = list(range(64)), 16
        ctx_of = {i: rng.normal(size=(int(rng.integers(3, 8)), 64, 7)).astype(np.float32)
                  for i in items}
        kw = dict(n_loaders=4, n_writers=4)
    else:
        items, batch = list(range(10)), 4
        ctx_of = {i: np.ones((2, 64, 7), np.float32) * i for i in items if i % 2}
        kw = {}
    nj, gj, pj, dj = _run_pipeline(jpoints, items, ctx_of, batch, **kw)
    nt, gt, pt, dt = _run_pipeline(tpoints, items, ctx_of, batch, **kw)
    assert nt == nj == len(items)
    assert sorted(gt) == sorted(gj) == items
    for i in items:
        (a, aa), (b, ab) = gt[i], gj[i]
        assert aa == ab
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, ctx_of[i][:, :, 0].mean(axis=1))
    assert (pt.n_dispatches, pt.n_rows) == (pj.n_dispatches, pj.n_rows)
    assert len(dt.dispatched) == len(dj.dispatched) == pt.n_dispatches
    if case == "across_items":
        total = sum(len(c) for c in ctx_of.values())
        assert pt.n_rows == total and pt.n_dispatches == -(-total // batch)
        assert all(d == batch for d in dt.dispatched[:-1])


def test_context_predictor_pads_and_needs_a_device(monkeypatch):
    from syconn_tpu_torch.models.io import load_model, packaged_model_path

    model, _ = load_model(packaged_model_path("glia_pts"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpoints.ContextPredictor(model, npoints=128, batch=4)
    pred = tpoints.ContextPredictor(model, npoints=128, batch=4, device="cpu")
    coords, types = _cloud(2000, 4)
    ctx, _ = tpoints.extract_contexts(coords, types, ctx_size_nm=8000, npoints=128,
                                      n_contexts=6, rng=np.random.default_rng(0))
    out = pred.predict(ctx)
    assert out.shape == (6, 128, 2)
    with torch.inference_mode():
        direct = model(torch.from_numpy(np.concatenate([ctx[4:], np.zeros_like(ctx[:2])])))
    np.testing.assert_array_equal(out[4:], direct.numpy()[:2])
    assert pred.predict(ctx[:0]) is None


def _one_cell_wd(tmp_path):
    """A working directory with one cell: a surface-nets blob as its mesh
    and a chain skeleton through it."""
    from syconn_tpu_torch.backend import MeshStorage, SkeletonStorage
    from syconn_tpu_torch.handler.config import generate_default_conf
    from syconn_tpu_torch.mesh.surface_nets import surface_net_mesh
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset

    wd = str(tmp_path / "wd")
    generate_default_conf(wd, scaling=(10, 10, 20))
    ssd = SuperSegmentationDataset(working_dir=wd, sv_mapping={3: [3]}, create=True)
    sso = ssd.get_super_segmentation_object(3)
    mask = np.zeros((60, 30, 16), bool)
    mask[5:55, 8:22, 4:12] = True
    ms = MeshStorage(sso.mesh_path("sv"), read_only=False)
    ms[3] = list(surface_net_mesh(mask, scale=(10, 10, 20)))
    ms.push()
    n = 10
    nodes = np.stack([np.linspace(8, 52, n), np.full(n, 15), np.full(n, 8)], 1)
    ss = SkeletonStorage(sso.skeleton_path, read_only=False)
    ss[3] = {"nodes": nodes.astype(np.float32),
             "edges": np.stack([np.arange(n - 1), np.arange(1, n)], 1).astype(np.int64),
             "diameters": np.ones(n, np.float32)}
    ss.push()
    return wd


def test_steps_7_to_9_drivers_raise(monkeypatch, tmp_path):
    """Without a card the four step 7-9 functions raise unless given
    ``device="cpu"``; on the CPU each writes its outputs."""
    from _torch_helpers import port_wd
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wd = _one_cell_wd(tmp_path)
    with port_wd(wd):
        sso = SuperSegmentationDataset(working_dir=wd).get_super_segmentation_object(3)
        calls = [tpoints.predict_celltype_ssd, tpoints.predict_compartments_ssd,
                 tpoints.infere_cell_morphology_ssd,
                 lambda **kw: tpoints.predict_celltype_sso(sso, **kw)]
        for fn in calls:
            for kw in ({}, {"device": "cuda"}):
                with pytest.raises(RuntimeError, match="CUDA"):
                    fn(**kw)
        stats = {}
        assert tpoints.predict_compartments_ssd(device="cpu", stats=stats) == 1
        assert stats["contexts"] > 0 and stats["dispatches"] > 0
        assert tpoints.infere_cell_morphology_ssd(device="cpu") == 1
        assert tpoints.predict_celltype_ssd(device="cpu") == 1
        ct = tpoints.predict_celltype_sso(sso, device="cpu")
    assert 0 <= ct < 8
    ad = SuperSegmentationDataset(working_dir=wd).get_super_segmentation_object(3)
    ad.load_attr_dict()
    assert ad.load_skeleton() and len(ad.skeleton["axoness"]) == 10
    assert len(ad.attr_dict["axoness_vertex_labels"]) * 3 == len(ad.load_mesh("sv")[1])
    assert ad.attr_dict["latent_morph"].shape == (10,)
    assert 0 <= ad.attr_dict["celltype_cnn_e3_certainty"] <= 1


def test_view_route_raises_item_9(monkeypatch, tmp_path):
    """The view route (``use_point_models: False``, ROADMAP Queue 1 item 9,
    ported): without a card the three view-route entry points and the four
    ``*_nocache`` helpers raise ``RuntimeError`` (no device and
    ``device="cuda"``); with ``device="cpu"`` they run on a one-cell
    directory, seed-initialising the view nets where
    ``views.allow_untrained_models`` allows it."""
    from _torch_helpers import port_wd
    from syconn_tpu_torch.exec import exec_inference
    from syconn_tpu_torch.handler.config import generate_default_conf
    from syconn_tpu_torch.reps import super_segmentation_helper as ssh
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wd = _one_cell_wd(tmp_path)
    generate_default_conf(wd, scaling=(10, 10, 20), force_overwrite=True, key_value_pairs=[
        ("use_point_models", False), ("views", {"allow_untrained_models": True})])
    entry = (exec_inference.run_celltype_prediction, exec_inference.run_semsegaxoness_prediction,
             exec_inference.run_morphology_embedding)
    helpers = (ssh.celltype_of_sso_nocache, ssh.semseg_of_sso_nocache,
               ssh.view_embedding_of_sso_nocache, ssh.gliapred_sso_nocache)
    with port_wd(wd) as cfg:
        assert not cfg.use_point_models
        sso = SuperSegmentationDataset(working_dir=wd).get_super_segmentation_object(3)
        for fn in entry + tuple((lambda f: lambda **kw: f(sso, **kw))(h) for h in helpers):
            for kw in ({}, {"device": "cuda"}):
                with pytest.raises(RuntimeError, match="CUDA"):
                    fn(**kw)
        stats = {}
        assert all(fn(device="cpu", stats=stats) == 1 for fn in entry)
        assert stats["locations"] > 0 and stats["dispatches"] > 0
        assert 0.0 <= ssh.gliapred_sso_nocache(sso, device="cpu") <= 1.0
        assert ssh.view_embedding_of_sso_nocache(sso, device="cpu").shape == (10,)
        assert 0 <= ssh.celltype_of_sso_nocache(sso, device="cpu") < 8
        labels = ssh.semseg_of_sso_nocache(sso, device="cpu")
    assert sorted(os.listdir(os.path.join(wd, "models"))) == [
        "axoness_semseg", "celltype", "glia", "tnet"]
    ad = SuperSegmentationDataset(working_dir=wd).get_super_segmentation_object(3)
    ad.load_attr_dict()
    assert ad.load_skeleton() and len(ad.skeleton["axoness"]) == 10
    np.testing.assert_array_equal(ad.attr_dict["axoness_vertex_labels"], labels)
    assert len(labels) * 3 == len(ad.load_mesh("sv")[1])
    assert ad.attr_dict["latent_morph"].shape == (10,)
    assert 0 <= ad.attr_dict["celltype_cnn_e3_certainty"] <= 1
