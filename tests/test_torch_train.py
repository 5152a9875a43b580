"""The port's training harness (``syconn_tpu_torch/models/train.py``)
against the JAX package's optax loops.

* Optimizer: identical numpy gradients through optax's chain and the port's
  ``TrainState`` for 8 steps (a step whose global norm exceeds 1 and one
  below it; the constant rate, the ``total_steps`` schedule and the
  ``train_views`` schedule without clipping; every leaf decayed): params
  within 1e-6 relative to each leaf's largest magnitude (the two packages
  round ``p - lr * (u + wd * p)`` in different orders, a few f32 ulps of the
  leaf's scale, so an element passing near zero has no relative error of
  its own).
* Steps: from the same initial params and batch, one step of each step
  function (dense U-Net with ``weighted_xent`` and ``-1`` labels, class
  step on the hybrid ``PointClassNet``, seg step on ``PointSegNet``, the
  triplet step, and the view-CMN step of ``cnn/train_views.py``). The models
  compute in bf16, so the tolerances are measured ones: loss within 1e-2
  relative, ``acc`` within 0.02, and the params after the step with a median
  relative difference below 1e-6 (Adam's first step moves each parameter
  by about the learning rate times the sign of its gradient; a gradient
  whose sign differs between the packages moves one parameter by twice the
  rate, which the median ignores).
* ``cnn/train_views.py::train_view_classifier`` of both packages from the
  same initial params: every batch equal, the first two losses within
  1e-2 relative.
* The two convergence tests of ``tests/test_training.py``, port only, with
  the same data and thresholds, from the JAX test's initial params (the
  port's own seed initialisation already separates the triplet clouds by
  more than the margin, so its first loss is 0).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from syconn_tpu.models import train as J  # noqa: E402
from syconn_tpu_torch.models import train as T  # noqa: E402
from syconn_tpu_torch.models.convert import flax_tree_from_module, module_state_from_flax  # noqa: E402
from syconn_tpu_torch.models.pointnet import Dense  # noqa: E402
from syconn_tpu_torch.models.unet3d import LayerNorm  # noqa: E402

STEP_LOSS_RTOL = 1e-2
STEP_ACC_ATOL = 0.02
STEP_PARAM_MEDIAN_REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np_tree(params):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = Dense(3, 4, torch.float32)
        self.LayerNorm_0 = LayerNorm(4)


def _tiny_tree(rng):
    return {"Dense_0": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                        "bias": rng.normal(size=4).astype(np.float32) * 0.1},
            "LayerNorm_0": {"scale": 1 + rng.normal(size=4).astype(np.float32) * 0.1,
                            "bias": rng.normal(size=4).astype(np.float32) * 0.1}}


@pytest.mark.parametrize("kind", ["constant", "total_steps", "train_views"])
def test_optimizer_matches_optax(kind):
    rng = np.random.default_rng(3)
    params = _tiny_tree(rng)
    lr, steps = 3e-3, 8
    model = _Tiny()
    if kind == "train_views":
        sched = T.warmup_cosine_decay_schedule(0.0, lr, max(steps // 20, 1), steps)
        state = T.TrainState(model, sched, weight_decay=1e-4, clip_norm=None)
        tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, lr, max(steps // 20, 1), steps))
    else:
        total = steps if kind == "total_steps" else None
        state = T.make_train_state(model, (1, 3), learning_rate=lr, total_steps=total,
                                   device="cpu")
        tx = J.make_train_state(_JaxTiny(), (1, 3), learning_rate=lr, total_steps=total).tx
    model.load_state_dict(module_state_from_flax(params))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt = tx.init(jparams)
    norms = []
    for i in range(steps):
        # a gradient far above the clipping norm on odd steps, below it on even ones
        g = jax.tree_util.tree_map(
            lambda a: (rng.normal(size=a.shape) * (3.0 if i % 2 else 0.05)).astype(np.float32),
            params)
        norms.append(float(np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                       for v in _leaves(g).values()))))
        up, opt = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt, jparams)
        jparams = optax.apply_updates(jparams, up)
        for name, p in model.named_parameters():
            p.grad = module_state_from_flax(g)[name].clone()
        state.apply_gradients()
        ref, got = _leaves(_np_tree(jparams)), _leaves(flax_tree_from_module(model))
        for k in ref:
            scale = float(np.abs(ref[k]).max())
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=f"{k} @ {i}")
    assert min(norms) < 1.0 < max(norms)
    assert state.step == steps


def _JaxTiny():
    import flax.linen as nn

    class Tiny(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.LayerNorm()(nn.Dense(4)(x))

    return Tiny()


def test_schedule_matches_optax():
    for args in [(1e-4, 1e-3, 1, 8, 1e-3 / 30), (0.0, 2e-3, 5, 100, 0.0), (1e-4, 1e-3, 24, 800, 3e-5)]:
        ref = optax.warmup_cosine_decay_schedule(*args)
        got = T.warmup_cosine_decay_schedule(*args)
        for c in list(range(0, 30)) + [args[3] - 1, args[3], args[3] + 5]:
            assert got(c) == pytest.approx(float(ref(c)), rel=1e-6, abs=1e-12), (args, c)


def test_clip_is_optax_formula():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
    n = T.clip_by_global_norm_(g, 1.0)
    assert float(n) == 5.0
    f32 = np.float32
    assert g[0].tolist() == [float(f32(3) / f32(5) * f32(1)), float(f32(4) / f32(5) * f32(1))]
    small = [torch.tensor([0.3, 0.4])]
    T.clip_by_global_norm_(small, 1.0)
    assert small[0].tolist() == torch.tensor([0.3, 0.4]).tolist()


def test_losses_ignore_label_and_weights():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 6, 3)).astype(np.float32)
    labels = np.array([[0, 1, -1, 2, 2, -1], [1, 1, 0, -1, -1, -1]], np.int32)
    cw = np.array([0.5, 1.0, 2.0], np.float32)
    for w in (None, cw):
        ref = float(J.softmax_xent_loss(jnp.asarray(logits), jnp.asarray(labels),
                                        None if w is None else jnp.asarray(w)))
        got = float(T.softmax_xent_loss(torch.from_numpy(logits), torch.from_numpy(labels).long(),
                                        None if w is None else torch.from_numpy(w)))
        assert got == pytest.approx(ref, rel=1e-6)
    none = np.full((2, 6), -1, np.int32)
    assert float(T.softmax_xent_loss(torch.from_numpy(logits), torch.from_numpy(none))) == 0.0
    za, zp, zn = (rng.normal(size=(4, 5)).astype(np.float32) for _ in range(3))
    assert float(T.triplet_loss(*map(torch.from_numpy, (za, zp, zn)))) == pytest.approx(
        float(J.triplet_loss(*map(jnp.asarray, (za, zp, zn)))), rel=1e-6)


def test_multi_device_forms_raise():
    """The spatial forms build and take a step (``sp`` > 1 splits the
    U-Net's z, tests/test_torch_spatial.py holds it to the single-device
    step); what raises is a z the split rule cannot cut (``ValueError``
    naming the model's z downsampling f) and a spatial axis for a model
    that is no U-Net. The data and tensor forms run
    (tests/test_torch_parallel.py)."""
    from syconn_tpu_torch.models.pointnet import PointClassNet
    from syconn_tpu_torch.models.unet3d import UNet3D
    from syconn_tpu_torch.parallel.device import get_device_mesh

    cpu = [torch.device("cpu")] * 4
    kw = dict(features=(8, 16), strides=((2, 2, 2),), patch=(2, 2, 2), n_classes=2)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, (2, 8, 8, 16, 1)).astype(np.float32)
    y = (x[..., 0] > 127).astype(np.int64)
    for shape in ((2, 2), (1, 4)):
        mesh = get_device_mesh(axis_names=("data", "sp"), mesh_shape=shape, devices=cpu)
        state = T.make_train_state(UNet3D(**kw), None, device="cpu")
        step = T.make_train_step(mesh)
        state, m = step(state, x, y)
        assert state.step == 1 and np.isfinite(float(m["loss"]))
        assert [len(r) for r in state.placement.positions] == [shape[1]] * shape[0]
        with pytest.raises(ValueError, match="f = 4"):
            step(state, x[:, :, :, :6], y[:, :, :, :6])
        with pytest.raises(TypeError, match="UNet3D"):
            step(T.make_train_state(PointClassNet(n_classes=2, widths=(8, 12), k=4), None,
                                    device="cpu"), np.zeros((2, 16, 7), np.float32),
                 np.zeros(2, np.int64))
    mesh = get_device_mesh(axis_names=("data", "sp"), mesh_shape=(4, 1), devices=cpu)
    assert callable(T.make_train_step(mesh)) and callable(T.make_class_train_step(mesh))
    assert callable(T.make_train_step(mesh, spatial_axis=None))


# --------------------------------------------------------------- step parity
def _port_state(tmodel, jstate, lr, total_steps=None):
    state = T.make_train_state(tmodel, None, learning_rate=lr, total_steps=total_steps,
                               device="cpu")
    tmodel.load_state_dict(module_state_from_flax(_np_tree(jstate.params)))
    return state


def _compare_step(jstate, jm, tstate, tm):
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=STEP_LOSS_RTOL)
    if "acc" in jm:
        assert abs(float(tm["acc"]) - float(jm["acc"])) <= STEP_ACC_ATOL
    ref, got = _leaves(_np_tree(jstate.params)), _leaves(tstate.params)
    assert sorted(ref) == sorted(got)
    rel = np.concatenate([(np.abs(got[k] - ref[k]) / np.maximum(np.abs(ref[k]), 1e-3)).ravel()
                          for k in ref])
    assert np.median(rel) < STEP_PARAM_MEDIAN_REL, float(np.median(rel))
    return float(np.median(rel)), float(np.mean(rel > 1e-3))


def test_dense_step_matches_jax():
    from syconn_tpu.models.unet3d import UNet3D as JU
    from syconn_tpu_torch.models.unet3d import UNet3D as TU

    kw = dict(features=(8, 16), strides=((2, 2, 2),), patch=(2, 2, 2), n_classes=4)
    rng = np.random.default_rng(5)
    x = rng.integers(0, 255, (2, 16, 16, 8, 1)).astype(np.float32)
    y = rng.integers(0, 4, (2, 16, 16, 8)).astype(np.int32)
    y[:, :4] = -1
    cw = np.array([0.3, 1.2, 1.0, 1.5], np.float32)
    jstate = J.make_train_state(JU(**kw), (1, 16, 16, 8, 1), learning_rate=2e-3)
    tstate = _port_state(TU(**kw), jstate, 2e-3)
    jstate, jm = J.make_train_step(loss_fn=J.weighted_xent(cw))(jstate, jnp.asarray(x),
                                                                jnp.asarray(y))
    tstate, tm = T.make_train_step(loss_fn=T.weighted_xent(cw))(tstate, x, y)
    _compare_step(jstate, jm, tstate, tm)


def test_class_step_hybrid_matches_jax():
    from syconn_tpu.models.pointnet import PointClassNet as JP
    from syconn_tpu_torch.models.pointnet import PointClassNet as TP

    kw = dict(n_classes=8, widths=(16, 32), k=4, n_global=3)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 64, 10)).astype(np.float32)
    x[:, :, 7:] = rng.normal(size=(4, 1, 3))
    y = np.array([0, 3, 7, 3], np.int32)
    jstate = J.make_train_state(JP(**kw), (1, 64, 10), learning_rate=1e-3, total_steps=20)
    tstate = _port_state(TP(**kw), jstate, 1e-3, total_steps=20)
    jstate, jm = J.make_class_train_step(dict_output=True)(jstate, jnp.asarray(x), jnp.asarray(y))
    tstate, tm = T.make_class_train_step(dict_output=True)(tstate, x, y)
    _compare_step(jstate, jm, tstate, tm)


def test_seg_step_matches_jax():
    from syconn_tpu.models.pointnet import PointSegNet as JS
    from syconn_tpu_torch.models.pointnet import PointSegNet as TS

    kw = dict(n_classes=3, widths=(16, 32), k=4, knn_stages=2)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 64, 7)).astype(np.float32)
    y = rng.integers(-1, 3, (3, 64)).astype(np.int32)
    jstate = J.make_train_state(JS(**kw), (1, 64, 7), learning_rate=1e-3, total_steps=10)
    tstate = _port_state(TS(**kw), jstate, 1e-3, total_steps=10)
    jstate, jm = J.make_train_step()(jstate, jnp.asarray(x), jnp.asarray(y))
    tstate, tm = T.make_train_step()(tstate, x, y)
    _compare_step(jstate, jm, tstate, tm)


def test_triplet_step_matches_jax():
    from syconn_tpu.models.pointnet import PointClassNet as JP
    from syconn_tpu_torch.models.pointnet import PointClassNet as TP

    kw = dict(n_classes=2, widths=(16, 32), k=4, embed_dim=4)
    rng = np.random.default_rng(8)
    xa, xp, xn = (rng.normal(size=(4, 64, 7)).astype(np.float32) for _ in range(3))
    xn[..., 0] += 1.0
    jstate = J.make_train_state(JP(**kw), (1, 64, 7), learning_rate=3e-3)
    tstate = _port_state(TP(**kw), jstate, 3e-3)
    jstate, jm = J.make_triplet_train_step(margin=1.0)(jstate, *map(jnp.asarray, (xa, xp, xn)))
    tstate, tm = T.make_triplet_train_step(margin=1.0)(tstate, xa, xp, xn)
    _compare_step(jstate, jm, tstate, tm)


def test_view_step_matches_jax():
    """The step of ``cnn/train_views.py::train_view_classifier``: optax's
    adamw on the warmup-cosine schedule from 0, no clipping; mean cross
    entropy and accuracy."""
    from syconn_tpu.models.cmn import MultiViewCMN as JC
    from syconn_tpu_torch.cnn.train_views import make_view_train_state
    from syconn_tpu_torch.models.cmn import MultiViewCMN as TC

    rng = np.random.default_rng(9)
    x = rng.integers(0, 255, (4, 2, 32, 16, 4)).astype(np.float32)
    y = np.array([0, 1, 3, 3], np.int32)
    steps, lr = 40, 1e-3
    jmodel = JC(n_classes=8, widths=(16, 32, 64))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1,) + x.shape[1:]))["params"]
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, lr, max(steps // 20, 1), steps))
    opt = tx.init(params)
    tmodel = TC(n_classes=8, widths=(16, 32, 64))
    tstate = make_view_train_state(tmodel, lr, steps, seed=0, device="cpu")
    tmodel.load_state_dict(module_state_from_flax(_np_tree(params)))
    @jax.jit
    def step(params, opt_state, xb, yb):  # train_view_classifier's step
        def loss_fn(p):
            lg = jmodel.apply({"params": p}, xb)
            return optax.softmax_cross_entropy_with_integer_labels(lg, yb).mean(), lg

        (loss, lg), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        up, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, up), opt_state, loss, jnp.mean(jnp.argmax(lg, -1) == yb)

    for _ in range(2):  # step 0 runs at lr 0: only the decay-free moments move
        params, opt, loss, acc = step(params, opt, jnp.asarray(x), jnp.asarray(y))
        tstate, tm = T.make_class_train_step()(tstate, x, y)

    class _S:
        pass

    js = _S()
    js.params = params
    _compare_step(js, {"loss": loss, "acc": acc}, tstate, tm)


# ----------------------------------------------- convergence (port only)
def test_class_train_step_converges():
    from syconn_tpu_torch.models.pointnet import PointClassNet

    from syconn_tpu.models.pointnet import PointClassNet as JP

    kw = dict(n_classes=2, widths=(16, 32), k=4)
    state = _port_state(PointClassNet(**kw), J.make_train_state(JP(**kw), (1, 64, 7)), 5e-3)
    step = T.make_class_train_step(dict_output=True)
    rng = np.random.default_rng(0)
    xs, ys = [], []
    for k in range(2):
        for _ in range(8):
            pts = rng.normal(size=(64, 7)).astype(np.float32) * 0.1
            pts[:, 0] += (k * 2 - 1) * 0.8
            xs.append(pts)
            ys.append(k)
    x = np.stack(xs)
    y = np.asarray(ys, np.int32)
    accs = []
    for _ in range(30):
        state, m = step(state, x, y)
        accs.append(float(m["acc"]))
    assert accs[-1] > 0.9


def test_triplet_train_step_reduces_loss():
    from syconn_tpu_torch.models.pointnet import PointClassNet

    from syconn_tpu.models.pointnet import PointClassNet as JP

    kw = dict(n_classes=2, widths=(16, 32), k=4, embed_dim=4)
    state = _port_state(PointClassNet(**kw), J.make_train_state(JP(**kw), (1, 64, 7)), 3e-3)
    step = T.make_triplet_train_step(margin=1.0)
    rng = np.random.default_rng(0)

    def cloud(shift):
        pts = rng.normal(size=(4, 64, 7)).astype(np.float32) * 0.1
        pts[..., 0] += shift
        return pts

    losses = []
    for _ in range(25):
        xa, xp, xn = cloud(-1.0), cloud(-1.0), cloud(1.0)
        state, m = step(state, xa, xp, xn)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_view_trainer_batches_equal_jax(monkeypatch):
    """``train_view_classifier`` of both packages on the same view stacks:
    the JAX trainer's jitted step is wrapped to capture its initial params
    and every batch; the port's starts from those params. Batches (the
    class-balanced draws, the view-order flip and the mirror) equal, the
    losses of the first two steps within 1e-2 relative."""
    from syconn_tpu.cnn import train_views as JV
    from syconn_tpu_torch.cnn import train_views as TV
    from syconn_tpu_torch.models import train as TMod

    rng = np.random.default_rng(11)
    x = rng.integers(0, 255, (12, 2, 32, 16, 4)).astype(np.uint8)
    y = np.array([0, 1, 3, 3, 1, 0, 3, 1, 0, 3, 1, 0], np.int32)
    jax_batches, jax_losses, inits = [], [], []
    orig_jit = jax.jit

    def recording_jit(fn):
        jitted = orig_jit(fn)

        def call(*args):
            if len(args) == 4:  # step(params, opt_state, xb, yb)
                if not inits:
                    inits.append(_np_tree(args[0]))
                jax_batches.append((np.asarray(args[2]), np.asarray(args[3])))
                out = jitted(*args)
                jax_losses.append(float(out[2]))
                return out
            return jitted(*args)

        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    _, _, acc_j = JV.train_view_classifier(x, y, n_classes=4, steps=3, batch=4, widths=(8, 16),
                                           log_cb=lambda m: None)
    monkeypatch.setattr(jax, "jit", orig_jit)

    port_batches, port_losses = [], []
    orig_state, orig_step = TV.make_view_train_state, TMod.make_class_train_step

    def make_state(model, *a, **kw):
        st = orig_state(model, *a, **kw)
        model.load_state_dict(module_state_from_flax(inits[0]))
        return st

    def make_step(*a, **kw):
        fn = orig_step(*a, **kw)

        def step(state, xb, yb):
            port_batches.append((np.asarray(xb), np.asarray(yb)))
            state, m = fn(state, xb, yb)
            port_losses.append(float(m["loss"]))
            return state, m

        return step

    monkeypatch.setattr(TV, "make_view_train_state", make_state)
    monkeypatch.setattr(TMod, "make_class_train_step", make_step)
    _, params, acc_t = TV.train_view_classifier(x, y, n_classes=4, steps=3, batch=4,
                                                widths=(8, 16), log_cb=lambda m: None,
                                                device="cpu")
    assert len(port_batches) == len(jax_batches) == 3
    for (xj, yj), (xt, yt) in zip(jax_batches, port_batches):
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)
    for j, t in list(zip(jax_losses, port_losses))[:2]:
        assert t == pytest.approx(j, rel=STEP_LOSS_RTOL)
    assert 0.0 <= acc_t <= 1.0 and sorted(params) == sorted(inits[0])
