"""The port's synthetic worlds, batch generators and trainers against the
JAX package (``utils/testdata*.py``, ``models/traindata.py``,
``proc/stats.py``, ``cnn/toy.py``, ``cnn/toy_points.py``,
``cnn/calibrate.py``).

* Worlds, exact: ``generate_toy_world`` (host path) and
  ``generate_neuron_world`` for two seeds and shapes, every array, the RAG,
  ``sv2cell``, ``syn_gt`` and ``cells_meta``.
* Batches, exact: ``DenseVolumeData``, ``world2cloud``, ``augment_context``.
* Trainers: ``train_toy_dense_models`` (organelles with ``start.py``'s
  override, myelin at mag 4, reduced widths) and ``train_toy_point_models``
  (celltype and spiness, a few steps). The JAX trainer's initial params are
  captured (its ``make_train_state`` wrapped) and the port's trainer starts
  from them; the batches each side feeds its step function and the class
  weights are equal, the first two steps' losses agree within 1e-2
  relative (measured: ~1e-4).
* Calibration: on the JAX trainer's own myelin params and training volumes,
  the port's ``calibrate_binary_threshold`` (its dense predictor's plain
  engine, which follows the Pallas kernel's f32 epilogue, where the JAX
  predictor on the CPU runs flax ``apply``) gives JAX's threshold, or one
  within a sweep step (8) with an IoU within 1e-3 of JAX's.
* Model files both ways: the port trains two steps and saves; the JAX
  package's ``load_model`` reads it and flax ``apply`` agrees with the
  port's forward within the dense budgets; a JAX-saved model loads into
  the port with the same agreement.
* ``model_performance`` and ``FileTimer`` as in JAX; ``calibrate``'s CLI
  on a copy of the packaged weights.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from _torch_helpers import port_wd

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from syconn_tpu_torch.models.convert import module_state_from_flax  # noqa: E402

FIRST_LOSS_RTOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np_tree(params):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("kw", [dict(shape=(48, 48, 24), n_cells=3, seed=0),
                                dict(shape=(64, 56, 32), n_cells=4, svs_per_cell=2, seed=5)])
def test_toy_world_equal_jax(kw, monkeypatch):
    from syconn_tpu.utils.testdata import generate_toy_world as J
    from syconn_tpu_torch.utils.testdata import generate_toy_world as T

    ref, got = J(device=False, **kw), T(**kw)
    _same(ref, got)
    _same(ref, T(device="auto", **kw))
    # device=True is the device generator on the card
    # (tests/test_torch_world_device.py): without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T(device=True, **kw)


@pytest.mark.parametrize("kw", [dict(shape=(64, 64, 32), n_cells=3, seed=1),
                                dict(shape=(96, 80, 40), n_cells=4, seed=4)])
def test_neuron_world_equal_jax(kw):
    from syconn_tpu.utils.testdata_neuro import generate_neuron_world as J
    from syconn_tpu_torch.utils.testdata_neuro import generate_neuron_world as T

    ref, got = J(**kw), T(**kw)
    _same(ref, got)
    assert len(got["syn_gt"]) > 0


def test_dense_volume_data_equal_jax(tmp_path):
    from syconn_tpu.io.chunked import ChunkedVolume as JV
    from syconn_tpu.models.traindata import DenseVolumeData as JD
    from syconn_tpu_torch.io.chunked import ChunkedVolume as TV
    from syconn_tpu_torch.models.traindata import DenseVolumeData as TD

    vol = np.random.default_rng(0).integers(0, 255, (64, 64, 32), dtype=np.uint8)
    lab = (vol > 128).astype(np.int32)
    for V, name in ((JV, "j"), (TV, "t")):
        V.create(str(tmp_path / name), scale=(10, 10, 20), boundary=vol.shape,
                 chunk_shape=(32, 32, 32)).save_raw(vol, mags=(1, 2))

    def label_fn(off, size):
        return lab[off[0]:off[0] + size[0], off[1]:off[1] + size[1], off[2]:off[2] + size[2]]

    for mag in (1, 2):
        ij = iter(JD(str(tmp_path / "j"), label_fn, tile_shape=(16, 16, 8), batch_size=3,
                     seed=4, mag=mag))
        it = iter(TD(str(tmp_path / "t"), label_fn, tile_shape=(16, 16, 8), batch_size=3,
                     seed=4, mag=mag))
        for _ in range(3):
            (xj, yj), (xt, yt) = next(ij), next(it)
            assert xt.shape == (3, 16, 16, 8, 1) and xt.dtype == xj.dtype
            np.testing.assert_array_equal(xt, xj)
            np.testing.assert_array_equal(yt, yj)


def test_model_performance_and_file_timer(tmp_path):
    from syconn_tpu.proc import stats as J
    from syconn_tpu_torch.proc import stats as T

    rng = np.random.default_rng(0)
    cases = [(np.array([[0.9, 0.1], [0.2, 0.8], [0.7, 0.3]]), np.array([0, 1, 0]))]
    cases += [(rng.random((n, 4)), rng.integers(0, 5, n)) for n in (5, 40, 200)]
    cases += [(rng.integers(0, 3, 30), rng.integers(1, 4, 30))]
    # no prediction right (scikit-learn prints the supports as floats), and
    # one class all wrong beside a right one (integers)
    cases += [(np.array([1, 1, 0, 0]), np.array([0, 0, 1, 1])),
              (np.array([1, 2, 0]), np.array([0, 1, 2])),
              (np.array([1, 1, 0, 0, 2]), np.array([0, 0, 1, 1, 2]))]
    for probas, labels in cases:
        assert T.model_performance(probas, labels) == J.model_performance(probas, labels)
    T.model_performance(*cases[0], model_dir=str(tmp_path / "m"), prefix="glia")
    J.model_performance(*cases[0], model_dir=str(tmp_path / "j"), prefix="glia")
    assert (tmp_path / "m" / "glia_performance.txt").read_text() == \
        (tmp_path / "j" / "glia_performance.txt").read_text()

    tt = T.FileTimer(str(tmp_path))
    for name in ("Preparation", "Dense predictions", "Preparation"):
        tt.start(name)
        tt.stop()
    with pytest.raises(RuntimeError):
        tt.stop()
    tt.timings = {"a": 3.0, "b": 1.0}
    tt.dataset_shape, tt.dataset_scale = (100, 100, 50), (10, 10, 20)
    tt._save()
    tj = J.FileTimer(str(tmp_path))  # the JAX reader takes the port's file
    assert tj.timings == tt.timings and tj.prepare_report() == tt.prepare_report()
    assert tj.dataset_mm3 == tt.dataset_mm3
    with T.FileTimer(str(tmp_path), overwrite=True) as t2:
        t2.start("x")
    assert list(t2.timings) == ["x"]


def test_world2cloud_and_augment_equal_jax():
    from syconn_tpu.cnn import toy_points as J
    from syconn_tpu_torch.cnn import toy_points as T
    from syconn_tpu_torch.utils.testdata_neuro import generate_neuron_world

    world = generate_neuron_world(shape=(64, 64, 32), n_cells=3, seed=1)
    for cid in (1, 2, 3, 9):
        _same(J.world2cloud(world, cid), T.world2cloud(world, cid))
        a = J._cell_contexts(world, cid, 128, 20_000.0, 4, np.random.default_rng(cid),
                             label_kind="both")
        b = T._cell_contexts(world, cid, 128, 20_000.0, 4, np.random.default_rng(cid),
                             label_kind="both")
        _same(a, b)
    ctx = np.random.default_rng(2).normal(size=(128, 7)).astype(np.float32)
    for seed in range(4):
        _same(J.augment_context(ctx, np.random.default_rng(seed)),
              T.augment_context(ctx, np.random.default_rng(seed)))


# ------------------------------------------------------------------ trainers
class _Recorder:
    """Wraps a training module's ``make_train_state`` (capturing the initial
    params, or replacing them by given ones), its step factories (capturing
    every batch and loss) and ``weighted_xent`` (capturing class weights)."""

    def __init__(self, monkeypatch, mod, port: bool, inits=None):
        self.inits, self.batches, self.losses, self.weights = [], [], [], []
        orig_state = mod.make_train_state

        def make_state(model, shape, *a, **kw):
            st = orig_state(model, shape, *a, **kw)
            if port:
                model.load_state_dict(module_state_from_flax(inits.pop(0)))
            else:
                self.inits.append(_np_tree(st.params))
            return st

        monkeypatch.setattr(mod, "make_train_state", make_state)
        for name in ("make_train_step", "make_class_train_step", "make_triplet_train_step"):
            monkeypatch.setattr(mod, name, self._wrap_factory(getattr(mod, name)))
        orig_wx = mod.weighted_xent

        def wx(cw):
            self.weights.append(np.asarray(cw, np.float64))
            return orig_wx(cw)

        monkeypatch.setattr(mod, "weighted_xent", wx)

    def _wrap_factory(self, factory):
        def make(*a, **kw):
            fn = factory(*a, **kw)

            def step(state, *xs):
                self.batches.append([np.asarray(x) for x in xs])
                state, m = fn(state, *xs)
                self.losses.append(float(m["loss"]))
                return state, m

            return step

        return make


def _compare_runs(rj, rt):
    assert len(rj.batches) == len(rt.batches) > 0
    for bj, bt in zip(rj.batches, rt.batches):
        for a, b in zip(bj, bt):
            np.testing.assert_array_equal(b, a)
    assert len(rj.weights) == len(rt.weights)
    for a, b in zip(rj.weights, rt.weights):
        np.testing.assert_array_equal(b.astype(np.float32), a.astype(np.float32))
    return [abs(t / j - 1) for j, t in zip(rj.losses, rt.losses)]


def _jax_wd(wd):
    from syconn_tpu import global_params
    from syconn_tpu.handler.config import generate_default_conf

    generate_default_conf(wd, scaling=(10, 10, 20))
    global_params.wd = wd
    return global_params


@pytest.fixture(scope="module")
def dense_runs(tmp_path_factory):
    """Both packages' ``train_toy_dense_models`` on one toy world: the
    organelles U-Net with ``start.py``'s override (features 32/64, one
    stride-2 level, patch (2, 2, 2)) and myelin at mag 4 (features 8/16),
    3 steps each; the port from the JAX trainer's initial params."""
    from syconn_tpu import global_params as jparams
    from syconn_tpu.cnn import toy as JT
    from syconn_tpu.models import train as JM
    from syconn_tpu_torch.cnn import toy as TT
    from syconn_tpu_torch.handler.config import generate_default_conf
    from syconn_tpu_torch.models import train as TM
    from syconn_tpu_torch.utils.testdata import generate_toy_world

    base = tmp_path_factory.mktemp("dense")
    packaged = _packaged_bytes()
    world = generate_toy_world(shape=(96, 96, 48), n_cells=3, seed=11)
    kw = dict(steps=3, tile=(64, 64, 32), batch=2, tasks=("organelles", "myelin"),
              variant_overrides={"organelles": dict(features=(32, 64), strides=((2, 2, 2),),
                                                    patch=(2, 2, 2)),
                                 "myelin": dict(features=(8, 16))})
    mp = pytest.MonkeyPatch()
    prev = jparams.wd
    try:
        _jax_wd(str(base / "jax"))
        rj = _Recorder(mp, JM, port=False)
        JT.train_toy_dense_models(world, **kw)
        jparams.wd = prev
        wt = str(base / "torch")
        generate_default_conf(wt, scaling=(10, 10, 20))
        rt = _Recorder(mp, TM, port=True, inits=list(rj.inits))
        with port_wd(wt):
            TT.train_toy_dense_models(world, device="cpu", **kw)
    finally:
        jparams.wd = prev
        mp.undo()
    # the port's mpath_* name the packaged weights until a working directory
    # holds its own: the trainers write to <wd>/models only
    assert _packaged_bytes() == packaged
    return world, base, rj, rt


def _packaged_bytes():
    from syconn_tpu_torch.models.io import packaged_model_path

    root = os.path.dirname(packaged_model_path("myelin"))
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.join(d, f)] = fh.read()
    return out


def test_toy_dense_trainer_equal_jax(dense_runs):
    world, base, rj, rt = dense_runs
    rel = _compare_runs(rj, rt)
    assert len(rt.batches) == 6 and len(rt.weights) == 2
    assert rt.batches[0][0].shape == (2, 64, 64, 32, 1)
    assert rt.batches[3][0].shape == (2, 24, 24, 12, 1)  # myelin at mag 4
    for first in (0, 1, 3, 4):  # the first two steps of each task
        assert rel[first] < FIRST_LOSS_RTOL, rel
    from syconn_tpu_torch.models.io import load_model, load_model_meta

    for task in ("organelles", "myelin"):
        mj = json.load(open(base / "jax" / "models" / task / "arch.json"))
        mt = json.load(open(base / "torch" / "models" / task / "arch.json"))
        assert mt["cls"] == mj["cls"] == "UNet3D" and mt["kwargs"] == mj["kwargs"]
        assert sorted(mt["meta"]) == sorted(mj["meta"])
        model, params = load_model(str(base / "torch" / "models" / task))
        assert model.features == tuple(mj["kwargs"]["features"])
    meta = load_model_meta(str(base / "torch" / "models" / "myelin"))
    assert meta["mag"] == 4 and 8 <= meta["threshold"] <= 248


def _assert_calibration(thr, iou, ref_thr, ref_iou):
    assert thr == ref_thr or (abs(thr - ref_thr) <= 8 and abs(iou - ref_iou) <= 1e-3), \
        (thr, iou, ref_thr, ref_iou)


def test_calibrated_threshold_matches_jax(dense_runs):
    """The JAX trainer's calibration, repeated by the port on the JAX
    trainer's own myelin params and training volume (measured: the same
    threshold and IoU)."""
    from syconn_tpu.cnn import toy as JT
    from syconn_tpu_torch.cnn import toy as TT
    from syconn_tpu_torch.models.io import load_model

    world, base, _, _ = dense_runs
    mdir = str(base / "jax" / "models" / "myelin")
    meta = json.load(open(os.path.join(mdir, "arch.json")))["meta"]
    model, params = load_model(mdir)
    raw = JT._pool_mean(world["raw"], 4)
    np.testing.assert_array_equal(TT._pool_mean(world["raw"], 4), raw)
    lab = ((world["cells"] == 0) & (world["raw"] < 90)).astype(np.int32)
    tgt = JT._pool_any(lab, 4)
    np.testing.assert_array_equal(TT._pool_any(lab, 4), tgt)
    from scipy import ndimage

    tgt = ndimage.binary_dilation(tgt > 0, iterations=TT.myelin_dilation(4)).astype(np.int32)
    thr, iou = TT.calibrate_binary_threshold(model, params, [raw], [tgt], device="cpu")
    _assert_calibration(thr, iou, meta["threshold"], meta["calib_train_iou"])


def test_calibration_of_packaged_myelin_matches_jax():
    """Both packages' ``calibrate_binary_threshold`` on the packaged myelin
    weights and two neuron worlds (measured: threshold 80 on both, IoU
    0.08116 and 0.08107)."""
    from scipy import ndimage

    from syconn_tpu.cnn.toy import calibrate_binary_threshold as J
    from syconn_tpu.models import io as jio
    from syconn_tpu_torch.cnn.toy import calibrate_binary_threshold as T
    from syconn_tpu_torch.models import io as tio
    from syconn_tpu_torch.utils.testdata_neuro import generate_neuron_world

    raws, tgts = [], []
    for s in (0, 1):
        w = generate_neuron_world(shape=(96, 96, 48), n_cells=4, seed=s)
        raws.append(w["raw"])
        tgts.append(ndimage.binary_dilation(w["myelin"] > 0, iterations=3))
    ref = J(*jio.load_model(jio.packaged_model_path("myelin")), raws, tgts)
    got = T(*tio.load_model(tio.packaged_model_path("myelin")), raws, tgts, device="cpu")
    assert 8 < ref[0] < 248
    _assert_calibration(*got, *ref)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_model_files_round_trip(tmp_path, direction):
    from syconn_tpu.models import io as jio
    from syconn_tpu.models.unet3d import UNet3D as JU
    from syconn_tpu_torch.models import io as tio
    from syconn_tpu_torch.models import train as TM
    from syconn_tpu_torch.models.unet3d import UNet3D as TU

    kw = dict(features=(8, 16), strides=((2, 2, 2),), patch=(2, 2, 2), n_classes=4)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 255, (1, 16, 16, 8, 1)).astype(np.float32)
    path = str(tmp_path / "m")
    if direction == "port_to_jax":
        model = TU(**kw)
        state = TM.make_train_state(model, None, learning_rate=1e-2, device="cpu")
        step = TM.make_train_step()
        for _ in range(2):
            state, _ = step(state, x, rng.integers(0, 4, (1, 16, 16, 8)))
        tio.save_model(path, model, state.params, extra_meta={"task": "organelles"})
        jm, jp = jio.load_model(path)
        tm = model
        assert jio.load_model_meta(path) == {"task": "organelles"}
    else:
        jm = JU(**kw)
        jp = jio.init_model_params(jm, (1, 16, 16, 8, 1), seed=3)
        jio.save_model(path, jm, jp, extra_meta={"task": "organelles"})
        tm, _ = tio.load_model(path)
    ref = np.asarray(jm.apply({"params": jp}, jnp.asarray(x), full_res=False), np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), full_res=False).float().numpy()
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 0.05)
    assert np.median(rel) < 3e-2, float(np.median(rel))
    pv = ref.shape[-1] // 4
    flips = np.mean(ref.reshape(ref.shape[:-1] + (4, pv)).argmax(-2)
                    != got.reshape(got.shape[:-1] + (4, pv)).argmax(-2))
    assert flips < 2e-2


def test_toy_point_trainer_equal_jax(tmp_path, monkeypatch):
    """``train_toy_point_models`` for celltype (class step) and spiness
    (weighted seg step on spine-head-centred and general pools), 3 steps
    each at reduced npoints, from the JAX trainer's initial params."""
    from syconn_tpu import global_params as jparams
    from syconn_tpu.cnn import toy_points as JP
    from syconn_tpu.models import train as JM
    from syconn_tpu_torch.cnn import toy_points as TP
    from syconn_tpu_torch.handler.config import generate_default_conf
    from syconn_tpu_torch.models import train as TM
    from syconn_tpu_torch.utils.testdata_neuro import generate_neuron_world

    worlds = [generate_neuron_world(shape=(64, 64, 32), n_cells=3, seed=s) for s in (1, 2)]
    kw = dict(tasks=("celltype", "spiness"), steps=3, npoints=128, batch=4,
              task_npoints={"spiness": 64})
    prev = jparams.wd
    try:
        _jax_wd(str(tmp_path / "jax"))
        rj = _Recorder(monkeypatch, JM, port=False)
        mj = JP.train_toy_point_models(worlds, **kw)
    finally:
        jparams.wd = prev
    wt = str(tmp_path / "torch")
    generate_default_conf(wt, scaling=(10, 10, 20))
    rt = _Recorder(monkeypatch, TM, port=True, inits=list(rj.inits))
    with port_wd(wt):
        mt = TP.train_toy_point_models(worlds, device="cpu", **kw)
    assert sorted(mt) == sorted(mj)
    rel = _compare_runs(rj, rt)
    assert len(rt.batches) == 6 and len(rt.weights) == 1
    assert rt.batches[3][0].shape == (4, 64, 7)
    for first in (0, 1, 3, 4):
        assert rel[first] < FIRST_LOSS_RTOL, rel
    for name in ("celltype_pts", "spiness"):
        aj = json.load(open(tmp_path / "jax" / "models" / name / "arch.json"))
        at = json.load(open(tmp_path / "torch" / "models" / name / "arch.json"))
        assert at == aj


def test_calibrate_cli_on_a_copy(tmp_path):
    """``python -m syconn_tpu_torch.cnn.calibrate --model_dir <copy>``
    writes the threshold into the copy's meta and leaves the packaged
    weights alone; the threshold is the port's calibration on the same
    worlds."""
    from syconn_tpu_torch.cnn import calibrate
    from syconn_tpu_torch.cnn.toy import calibrate_binary_threshold, myelin_dilation
    from syconn_tpu_torch.models.io import load_model, packaged_model_path
    from syconn_tpu_torch.utils.testdata_neuro import generate_neuron_world

    src = packaged_model_path("myelin")
    before = open(os.path.join(src, "arch.json")).read()
    shutil.copytree(src, tmp_path / "myelin")
    calibrate.main(["--tasks", "myelin", "er", "--shape", "48", "48", "24", "--n_cells", "3",
                    "--model_dir", str(tmp_path), "--device", "cpu"])
    assert open(os.path.join(src, "arch.json")).read() == before
    meta = json.load(open(tmp_path / "myelin" / "arch.json"))["meta"]
    model, params = load_model(str(tmp_path / "myelin"))
    from scipy import ndimage

    raws, tgts = [], []
    for s in calibrate.TRAIN_SEEDS:
        w = generate_neuron_world(shape=(48, 48, 24), n_cells=3, seed=s)
        raws.append(w["raw"])
        tgts.append(ndimage.binary_dilation(w["myelin"] > 0, iterations=myelin_dilation(1)))
    thr, iou = calibrate_binary_threshold(model, params, raws, tgts, device="cpu")
    assert meta["threshold"] == thr and meta["calib_train_iou"] == round(iou, 4)
    assert not (tmp_path / "er").exists()
