"""The port's multi-device layer (``syconn_tpu_torch/parallel/``,
``models/train.py``'s mesh forms) on logical CPU meshes: several mesh
positions naming the CPU, as the JAX package's tests use 8 virtual CPU
devices (tests/test_halo.py, test_sharded_pipeline.py, test_pipeline_pp.py,
test_models_dense.py::test_train_step_sharded_multichip).

Tolerances: the mesh, halo and step functions hold integers and are
compared exactly, against the port's serial path and the JAX package's
sharded functions on the same seeded inputs (small sizes: JAX runs them
over its virtual devices). The pipeline's forward and gradients are within
1e-5 of the serial stage composition and of JAX's ``pipeline_apply``.
Training steps on a mesh: the loss within 1e-4 relative of the
single-device step's; a tensor-parallel step with one data position equals
it exactly (the same forward, gradients split and updated shard by shard);
with several data positions the gradients are summed in another order, and
AdamW divides each gradient by its own magnitude, so a gradient near zero
can move its parameter by up to twice the learning rate the other way:
there the median parameter difference is within 1e-5 and the largest
within 2 * lr per step.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from syconn_tpu_torch.parallel import device as tdev  # noqa: E402
from syconn_tpu_torch.parallel import sharded as tsh  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _tmesh(n, axes=("sp",), shape=None):
    return tdev.get_device_mesh(axis_names=axes, mesh_shape=shape, devices=[CPU] * n)


def _jmesh(n, axis):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} virtual devices")
    return Mesh(np.array(devs[:n]), (axis,))


def _toy_seg(sh, rng, n_labels=6, blocks=40):
    # tests/test_sharded_pipeline.py::_toy_seg
    seg = np.zeros(sh, np.uint32)
    for _ in range(blocks):
        o = [rng.integers(0, s - 4) for s in sh]
        e = [min(s, o[i] + int(rng.integers(4, 16))) for i, s in enumerate(sh)]
        seg[o[0]:e[0], o[1]:e[1], o[2]:e[2]] = rng.integers(1, n_labels + 1)
    return seg


# ------------------------------------------------------------------ mesh


@pytest.mark.parametrize("n, axes, shape", [
    (8, ("data", "sp"), None), (8, ("data", "sp"), (4, -1)), (4, ("data", "tp"), (2, 2)),
    (6, ("sp",), None)])
def test_get_device_mesh_matches_jax(n, axes, shape):
    from syconn_tpu.parallel.device import get_device_mesh as jget

    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    jm = jget(n, axis_names=axes, mesh_shape=shape)
    tm = tdev.get_device_mesh(n, axis_names=axes, mesh_shape=shape, devices=[CPU] * 8)
    assert list(tm.shape.items()) == list(jm.shape.items())
    assert tm.axis_names == jm.axis_names and tm.devices.size == n
    assert set(tm.devices.ravel()) == {CPU}


def test_get_device_mesh_errors(monkeypatch):
    from syconn_tpu.parallel.device import get_device_mesh as jget

    with pytest.raises(ValueError) as je:
        jget(8, axis_names=("data", "sp"), mesh_shape=(3, 2))
    with pytest.raises(ValueError) as te:
        tdev.get_device_mesh(8, axis_names=("data", "sp"), mesh_shape=(3, 2),
                             devices=[CPU] * 8)
    assert str(te.value) == str(je.value)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.get_device_mesh()


def test_placement_helpers():
    mesh = _tmesh(4, ("data", "tp"), (2, 2))
    assert mesh.axis_devices("data") == [CPU, CPU] and mesh.axis_devices("pp") == [CPU]
    t = torch.arange(24).reshape(4, 6)
    shards = tdev.data_sharding(t, mesh, "data", dim=0)
    assert [tuple(s.shape) for s in shards] == [(2, 6), (2, 6)]
    assert torch.equal(tdev.gather(shards, CPU), t)
    cols = tdev.data_sharding(t, mesh, "tp", dim=1)
    assert torch.equal(tdev.gather(cols, CPU, dim=1), t)
    reps = tdev.replicated(t, mesh)
    assert len(reps) == 4 and all(r is reps[0] for r in reps)  # one copy per device
    with pytest.raises(ValueError, match="divide"):
        tdev.data_sharding(torch.zeros(5, 2), mesh, "data")


def test_mesh_from_config(monkeypatch, tmp_path):
    """None with fewer than two cards, on the CPU and with
    ``tpu.shard_pipeline: false``; else a mesh over every card."""
    from _torch_helpers import port_wd
    from syconn_tpu_torch.handler.config import generate_default_conf

    assert tsh.mesh_from_config() is None  # no card here
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    m = tsh.mesh_from_config(axis_name="data")
    assert dict(m.shape) == {"data": 4}
    assert [str(d) for d in m.devices] == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert tsh.mesh_from_config(device="cpu") is None
    wd = str(tmp_path / "wd")
    generate_default_conf(wd, scaling=(10, 10, 20),
                          key_value_pairs=[("tpu", {"shard_pipeline": False})])
    with port_wd(wd):
        assert tsh.mesh_from_config() is None


@pytest.mark.parametrize("pad", [False, True])
def test_slab_runs_equal_jax(pad):
    from syconn_tpu.parallel.sharded import slab_runs as jslab

    for grid, n in (((12, 2, 3), 8), ((4, 1, 1), 4), ((3, 2, 2), 2), ((5, 1, 2), 8)):
        assert tsh.slab_runs(grid, n, pad=pad) == jslab(grid, n, pad=pad)


# ------------------------------------------------------------------ halo


def test_sharded_boundary_matches_serial_and_jax(rng):
    from syconn_tpu.parallel.halo import sharded_boundary_mask as jmask
    from syconn_tpu_torch.ops.contacts import detect_seg_boundaries
    from syconn_tpu_torch.parallel.halo import sharded_boundary_mask

    base = rng.integers(0, 4, size=(16, 8, 4)).astype(np.int32)
    vol = np.kron(base, np.ones((4, 4, 4), np.int32))  # (64, 32, 16)
    serial = detect_seg_boundaries(vol.astype(np.uint32))
    got = sharded_boundary_mask(vol, _tmesh(8))
    assert got.dtype == bool and np.array_equal(got, serial)
    assert np.array_equal(got, np.asarray(jmask(vol, _jmesh(8, "sp"))).astype(bool))


@pytest.mark.parametrize("edge_mode", ["edge", "zero"])
def test_halo_exchange_slabs(edge_mode):
    """The exchanged halo holds exactly the neighbours' border slabs
    (tests/test_halo.py::test_halo_exchange_identity_kernel), edge slabs
    replicated or zero at the volume's ends."""
    from syconn_tpu_torch.parallel.halo import halo_exchange_x, sharded_volume_apply

    vol = np.arange(64 * 4 * 4, dtype=np.int32).reshape(64, 4, 4)
    mesh = _tmesh(8)
    out = sharded_volume_apply(lambda p: p[:1].expand((p.shape[0] - 2,) + p.shape[1:]), vol,
                               mesh, halo=1)
    for i in range(8):
        assert np.array_equal(out[8 * i], vol[max(8 * i - 1, 0)])
    shards = tdev.data_sharding(torch.from_numpy(vol), mesh, "sp")
    padded = halo_exchange_x(shards, 2, edge_mode=edge_mode)
    assert [tuple(p.shape) for p in padded] == [(12, 4, 4)] * 8
    t = torch.from_numpy(vol)
    for i, p in enumerate(padded):
        lo, hi = 8 * i - 2, 8 * i + 10
        want = t[max(lo, 0):min(hi, 64)]
        assert torch.equal(p[max(-lo, 0):12 - max(hi - 64, 0)], want)
    edge_lo, edge_hi = padded[0][:2], padded[-1][-2:]
    if edge_mode == "edge":
        assert torch.equal(edge_lo, t[:1].expand(2, 4, 4))
        assert torch.equal(edge_hi, t[-1:].expand(2, 4, 4))
    else:
        assert not edge_lo.any() and not edge_hi.any()


# ---------------------------------------------------------- sharded steps


@pytest.mark.parametrize("kernel, K", [("auto", 32), ("cuda", 32), ("auto", 2), ("cuda", 2)])
def test_detect_cs_slab_sharded(rng, monkeypatch, kernel, K):
    """Equal to the host kernel and to JAX's sharded detection on the JAX
    test's slab; K = 2 forces overflowing tiles (columns), which are
    patched in shard-local coordinates."""
    from syconn_tpu.parallel.sharded import detect_cs_slab_sharded as jdetect
    from syconn_tpu_torch.ops import contacts_torch
    from syconn_tpu_torch.ops.contacts import detect_cs

    stencil = (13, 13, 7)
    core = (64, 48, 24)
    seg = _toy_seg(tuple(core[i] + 2 * (stencil[i] // 2) for i in range(3)), rng)
    serial = detect_cs(seg, stencil=np.asarray(stencil, np.int32))
    n_over = []
    patch = contacts_torch._patch_overflow

    def counted(packed, overflow, *a):
        n_over.append(int(np.asarray(overflow).sum()))
        return patch(packed, overflow, *a)

    monkeypatch.setattr(contacts_torch, "_patch_overflow", counted)
    got = tsh.detect_cs_slab_sharded(seg, _tmesh(8), stencil=stencil, K=K, kernel=kernel)
    assert got.shape == serial.shape == core and np.array_equal(got, serial)
    assert len(n_over) == 8 and (sum(n_over) > 0) == (K == 2)
    if K == 32 and kernel == "auto":
        assert np.array_equal(got, jdetect(seg, _jmesh(8, "sp"), stencil=stencil))
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tsh.detect_cs_slab_sharded(seg.astype(np.uint64) + 2**31, _tmesh(8), stencil=stencil)


def test_segment_slab_sharded(rng):
    """Each shard's haloed masks equal the serial device chain on the
    window the serial path loads, and JAX's per-chunk chain."""
    from syconn_tpu.ops.morphology_jax import segment_chunk_device as jchain
    from syconn_tpu_torch.ops.morphology import get_aniso_struct
    from syconn_tpu_torch.ops.morphology_torch import segment_chunk_device

    struct = get_aniso_struct(np.array([10, 10, 20]))
    ops = ["binary_closing", "binary_erosion"]
    halo, cx, n = 3, 16, 4
    prob = (rng.random((n * cx + 2 * halo, 24 + 2 * halo, 16 + 2 * halo)) * 255).astype(np.uint8)
    prob[10:40, 6:20, 4:14] = 255
    masks, eroded, n_tr = tsh.segment_slab_sharded(prob, 128.0, ops, struct, _tmesh(n), halo,
                                                   sigma=1.0)
    assert n_tr == 1 and masks.shape == (n, cx + 2 * halo) + prob.shape[1:]
    for s in range(n):
        win = prob[s * cx:(s + 1) * cx + 2 * halo]
        m, e, _ = segment_chunk_device(win, 128.0, ops, struct, sigma=1.0, device="cpu")
        jm, je, _ = jchain(win, 128.0, ops, struct, sigma=1.0)
        assert np.array_equal(masks[s], m) and np.array_equal(eroded[s], e)
        assert np.array_equal(masks[s], np.asarray(jm))
        assert np.array_equal(eroded[s], np.asarray(je))
    assert masks.any() and not np.array_equal(masks, eroded)


def _same_props(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x).astype(np.int64), np.asarray(y).astype(np.int64))


@pytest.mark.parametrize("max_ids", [4096, 4])
def test_object_properties_and_pairs_sharded(rng, max_ids):
    """Equal to the host scans and to JAX's sharded scans; ``max_ids=4``
    makes every shard's table grow and the scan rerun."""
    from syconn_tpu.parallel.sharded import object_properties_sharded as jprops
    from syconn_tpu.parallel.sharded import pair_counts_sharded as jpairs
    from syconn_tpu_torch.ops.props import object_properties_arrays, pair_counts

    vol = _toy_seg((64, 32, 16), rng, n_labels=9)
    other = _toy_seg((64, 32, 16), rng, n_labels=5)
    mesh = _tmesh(8)
    got = tsh.object_properties_sharded(vol, mesh, max_ids=max_ids)
    _same_props(got, object_properties_arrays(vol))
    pairs = tsh.pair_counts_sharded(vol, other, mesh, max_pairs=max_ids)
    _same_props(pairs, pair_counts(vol, other))
    assert len(got[0]) > 4 and len(pairs[0]) > 4
    if max_ids == 4096:
        jm = _jmesh(8, "sp")
        _same_props(got, jprops(vol, jm))
        _same_props(pairs, jpairs(vol, other, jm))


def test_dense_labels_grow_the_tables():
    """tests/test_sharded_pipeline.py::test_object_properties_sharded_dense_labels
    at half the size: more labels per shard than the default table."""
    from syconn_tpu_torch.ops.props import object_properties_arrays, pair_counts

    sh = (32, 96, 96)
    vol = (np.arange(np.prod(sh), dtype=np.uint32).reshape(sh) // 12) + 1
    other = (vol % 7).astype(np.uint32) + 1
    mesh = _tmesh(4)
    got = tsh.object_properties_sharded(vol, mesh)
    assert len(got[0]) > 4 * 4096
    _same_props(got, object_properties_arrays(vol))
    _same_props(tsh.pair_counts_sharded(vol, other, mesh), pair_counts(vol, other))


def test_replicas_never_resolve_the_current_device(monkeypatch, rng):
    """On a card, ``default_device(None)`` inside a shard would give the
    current device, not the shard's: no sharded path may call it (every
    module's binding is replaced by one that refuses None). Each shard's
    work runs inside ``on_device`` of its own mesh position, in mesh order,
    on tensors placed there."""
    import sys

    from syconn_tpu_torch.inference.dense import DenseTilePredictor
    from syconn_tpu_torch.inference.points import ContextPredictor
    from syconn_tpu_torch.models import train as T
    from syconn_tpu_torch.models.convert import flax_tree_from_module
    from syconn_tpu_torch.models.io import init_model_params
    from syconn_tpu_torch.models.pointnet import PointClassNet
    from syconn_tpu_torch.models.unet3d import UNet3D
    from syconn_tpu_torch.ops import props_torch
    from syconn_tpu_torch.utils import device as udev

    real = udev.default_device

    def strict(device=None):
        assert device is not None, "a shard resolved the current device"
        return real(device)

    entered, seen = [], []

    def recording_on_device(d):
        entered.append(d)
        return tdev.on_device(d)

    for name, mod in list(sys.modules.items()):
        if name.startswith("syconn_tpu_torch"):
            if getattr(mod, "default_device", None) is real:
                monkeypatch.setattr(mod, "default_device", strict)
            if getattr(mod, "on_device", None) is tdev.on_device and mod is not tdev:
                monkeypatch.setattr(mod, "on_device", recording_on_device)
    real_scan = props_torch.object_properties_device

    def scan(local, cap):
        seen.append(local.device)
        return real_scan(local, cap)

    monkeypatch.setattr(props_torch, "object_properties_device", scan)
    mesh = _tmesh(4, ("sp",))
    vol = _toy_seg((32, 16, 8), rng)
    tsh.object_properties_sharded(vol, mesh)
    assert entered == mesh.axis_devices("sp") and seen == mesh.axis_devices("sp")
    tsh.detect_cs_slab_sharded(np.pad(vol, ((6, 6), (6, 6), (3, 3))), mesh)
    data = _tmesh(2, ("data",))
    unet = UNet3D(features=(8, 16), strides=((2, 2, 2),), patch=(2, 2, 2), n_classes=2)
    init_model_params(unet, seed=0)
    pred = DenseTilePredictor(unet, flax_tree_from_module(unet), tile_shape=(16, 16, 16),
                              halo=(0, 0, 0), device="cpu", mesh=data)
    pred.predict_tiles(np.zeros((2, 16, 16, 16), np.uint8))
    net = PointClassNet(n_classes=4, widths=(8,), k=4)
    init_model_params(net, seed=0)
    ContextPredictor(net, npoints=32, batch=2, device="cpu", mesh=data).predict(
        np.zeros((2, 32, 7), np.float32))
    state = T.make_train_state(UNet3D(features=(8, 16), strides=((2, 2, 2),), patch=(2, 2, 2),
                                      n_classes=2), None, device="cpu")
    T.make_train_step(data)(state, np.zeros((2, 16, 16, 16, 1), np.float32),
                            np.zeros((2, 16, 16, 16), np.int64))
    assert len(entered) == 4 + 4 + 2 + 2 + 2 and set(entered) == {CPU}


# -------------------------------------------------------------- pipeline


N_STAGES = 4


def _serial(stages, x):
    from syconn_tpu_torch.parallel.pipeline import _stage_fn

    for p in stages:
        x = _stage_fn(p, x)
    return x


def test_pipeline_forward_matches_serial_and_jax():
    from syconn_tpu.parallel import pipeline as J
    from syconn_tpu_torch.parallel import pipeline as P

    jp = J.init_stage_params(jax.random.PRNGKey(0), N_STAGES, width=32)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (6, 8, 32)))  # M = 6
    params = P.from_jax(jax.tree.map(np.asarray, jp))
    mesh = _tmesh(N_STAGES, ("pp",))
    out = P.pipeline_apply(params, torch.from_numpy(x), mesh)
    stages = [{k: v[s] for k, v in params.items()} for s in range(N_STAGES)]
    ref = torch.stack([_serial(stages, torch.from_numpy(x[m])) for m in range(6)])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    jout = np.asarray(J.pipeline_apply(jp, x, _jmesh(N_STAGES, "pp")))
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-5)
    restacked = P.stack_stage_params(stages)
    assert all(torch.equal(restacked[k], params[k]) for k in params)


def test_pipeline_grads_match_serial_and_jax():
    from syconn_tpu.parallel import pipeline as J
    from syconn_tpu_torch.parallel import pipeline as P

    jp = J.init_stage_params(jax.random.PRNGKey(2), N_STAGES, width=16)
    x = np.array(jax.random.normal(jax.random.PRNGKey(3), (5, 4, 16)))
    y = np.array(jax.random.normal(jax.random.PRNGKey(4), (5, 4, 16)))
    mesh = _tmesh(N_STAGES, ("pp",))
    params = {k: v.requires_grad_(True)
              for k, v in P.from_jax(jax.tree.map(np.asarray, jp)).items()}
    P.pipeline_loss(params, torch.from_numpy(x), torch.from_numpy(y), mesh).backward()
    ser = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    stages = [{k: v[s] for k, v in ser.items()} for s in range(N_STAGES)]
    out = torch.stack([_serial(stages, torch.from_numpy(x[m])) for m in range(5)])
    torch.mean((out - torch.from_numpy(y)) ** 2).backward()
    jg = jax.grad(J.pipeline_loss)(jp, x, y, _jmesh(N_STAGES, "pp"))
    for k in ("w", "b"):
        np.testing.assert_allclose(params[k].grad.numpy(), ser[k].grad.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(jg[k]), rtol=1e-5,
                                   atol=1e-5)


def test_pipeline_train_step_learns():
    from syconn_tpu_torch.parallel import pipeline as P

    mesh = _tmesh(N_STAGES, ("pp",))
    step, place = P.make_pipeline_train_step(mesh, lr=5e-3)
    stages = place(P.init_stage_params(torch.Generator().manual_seed(5), N_STAGES, width=16))
    assert len(stages) == N_STAGES and all(v.is_leaf for p in stages for v in p.values())
    g = torch.Generator().manual_seed(6)
    x = torch.randn((4, 8, 16), generator=g)
    y = x * 0.5 + 0.1
    losses = []
    for _ in range(30):
        stages, loss = step(stages, x, y)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses[::10]


# -------------------------------------------------------------- training


def _leaf_name(path):
    names = [getattr(k, "key", str(k)) for k in path]
    leaf = {"kernel": "weight"}.get(names[-1], names[-1])
    return ".".join(names[:-1] + [leaf])


@pytest.mark.parametrize("net", ["unet", "points"])
def test_state_shardings_match_jax(net):
    """Leaf by leaf: JAX's ``PartitionSpec`` of every parameter (the
    output-feature dim over ``tp``, or replicated) and the port's (dim,
    axis) through ``models/convert.py``'s names."""
    from syconn_tpu.models import train as J
    from syconn_tpu.parallel.device import get_device_mesh as jget
    from syconn_tpu_torch.models import train as T

    if net == "unet":
        from syconn_tpu.models.unet3d import UNet3D as JM
        from syconn_tpu_torch.models.unet3d import UNet3D as TM

        kw = dict(features=(6, 8), strides=((2, 2, 2),), patch=(2, 2, 2), n_classes=2)
        shape = (1, 16, 16, 16, 1)
    else:
        from syconn_tpu.models.pointnet import PointClassNet as JM
        from syconn_tpu_torch.models.pointnet import PointClassNet as TM

        kw = dict(n_classes=4, widths=(8, 12), k=4)
        shape = (1, 32, 7)
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    jstate = J.make_train_state(JM(**kw), shape)
    jspecs = J.state_shardings(jstate, jget(4, ("data", "tp"), (1, 4)), "tp")
    tstate = T.make_train_state(TM(**kw), shape, device="cpu")
    got = T.state_shardings(tstate, _tmesh(4, ("data", "tp"), (1, 4)), "tp")
    want = {}
    for path, sh in jax.tree_util.tree_leaves_with_path(jspecs.params):
        name = _leaf_name(path)
        spec = tuple(sh.spec)
        assert spec in ((), (None,) * (len(spec) - 1) + ("tp",)), spec
        if spec:
            p = dict(tstate.model.named_parameters())[name]
            want[name] = (0 if name.endswith(".weight") else p.ndim - 1, "tp")
        else:
            want[name] = None
    assert got == want
    assert any(v is not None for v in got.values()) and any(v is None for v in got.values())


def _unet_state(seed=0):
    from syconn_tpu_torch.models import train as T
    from syconn_tpu_torch.models.unet3d import UNet3D

    model = UNet3D(features=(16, 32), strides=((2, 2, 2),), patch=(2, 2, 2), n_classes=2)
    return T.make_train_state(model, None, learning_rate=1e-3, seed=seed, device="cpu")


def _params(state):
    return {k: v.detach().clone() for k, v in state.model.named_parameters()}


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
def test_mesh_train_step_matches_single_device(shape):
    """Three steps of the dense step (``weighted_xent``, ignore labels) on
    a ``data`` x ``tp`` mesh against the single-device step from the same
    state (tolerances: module docstring); the tensor-parallel parameters
    and their moments live as shards."""
    from syconn_tpu_torch.models import train as T

    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, (4, 16, 16, 16, 1)).astype(np.float32)
    y = (x[..., 0] > 127).astype(np.int64)
    y[0, :2] = -1
    loss_fn = T.weighted_xent([1.0, 2.0])
    single, sharded = _unet_state(), _unet_state()
    mesh = _tmesh(4, ("data", "tp"), shape)
    step1 = T.make_train_step(loss_fn=loss_fn)
    stepm = T.make_train_step(mesh, tensor_axis="tp", state_template=sharded, loss_fn=loss_fn)
    for i in range(3):
        single, m1 = step1(single, x, y)
        sharded, m2 = stepm(sharded, x, y)
        assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-4)
        assert abs(float(m2["acc"]) - float(m1["acc"])) <= 1e-3
    a, b = _params(single), _params(sharded)
    diff = np.concatenate([(a[k] - b[k]).abs().numpy().ravel() for k in a])
    if shape[0] == 1:
        assert diff.max() == 0.0
    else:
        assert np.median(diff) <= 1e-5 and diff.max() <= 2 * 1e-3 * 3
    pl = sharded.placement
    layout = {k for k, v in T.state_shardings(sharded, mesh, "tp").items() if v}
    assert set(pl.shards) == layout and (len(layout) >= 8) == (shape[1] > 1)
    for name, pieces in pl.shards.items():
        full = b[name]
        assert torch.equal(torch.cat([q.detach() for q in pieces]), full)
        for q in pieces:
            st = sharded.optimizer.state[q]
            assert st["exp_avg"].shape == q.shape and float(st["step"]) == 3
    assert sharded.step == 3


def test_class_step_on_a_data_mesh_matches_single_device():
    from syconn_tpu_torch.models import train as T
    from syconn_tpu_torch.models.pointnet import PointClassNet

    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 64, 7)).astype(np.float32)
    y = np.array([0, 3, 2, 3], np.int64)
    states = [T.make_train_state(PointClassNet(n_classes=4, widths=(16, 32), k=4), None,
                                 device="cpu") for _ in range(2)]
    s1, m1 = T.make_class_train_step(dict_output=True)(states[0], x, y)
    s2, m2 = T.make_class_train_step(_tmesh(4, ("data",)), dict_output=True)(states[1], x, y)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-4)
    assert float(m2["acc"]) == float(m1["acc"])
    a, b = _params(s1), _params(s2)
    diff = np.concatenate([(a[k] - b[k]).abs().numpy().ravel() for k in a])
    assert np.median(diff) <= 1e-5 and diff.max() <= 2 * 1e-3


def test_train_dense_on_a_mesh_matches_jax_single_device():
    """``train_dense(mesh=)`` of the port against the JAX package's
    single-device ``train_dense`` from the same initial params: losses
    within the tolerance of tests/test_torch_train.py's step parity (1e-2;
    the models compute in bf16)."""
    from syconn_tpu.models import train as J
    from syconn_tpu.models.unet3d import UNet3D as JU
    from syconn_tpu_torch.models import train as T
    from syconn_tpu_torch.models.convert import module_state_from_flax
    from syconn_tpu_torch.models.unet3d import UNet3D as TU

    kw = dict(features=(8, 16), strides=((2, 2, 2),), patch=(2, 2, 2), n_classes=2)
    rng = np.random.default_rng(1)
    batches = [(rng.integers(0, 255, (2, 16, 16, 8, 1)).astype(np.float32),) for _ in range(3)]
    batches = [(x, (x[..., 0] > 127).astype(np.int32)) for (x,) in batches]
    jstate = J.make_train_state(JU(**kw), (1, 16, 16, 8, 1), learning_rate=1e-3)
    model = TU(**kw)
    tstate = T.make_train_state(model, None, learning_rate=1e-3, device="cpu")
    model.load_state_dict(module_state_from_flax(
        jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jstate.params)))
    _, jh = J.train_dense(JU(**kw), iter([(jnp.asarray(x), jnp.asarray(y)) for x, y in batches]),
                          3, (1, 16, 16, 8, 1), state=jstate, log_every=1)
    _, th = T.train_dense(model, iter(batches), 3, None, mesh=_tmesh(2, ("data",)),
                          state=tstate, log_every=1)
    assert [h[0] for h in th] == [1, 2, 3]
    for (_, jl, _), (_, tl, _) in zip(jh, th):
        assert tl == pytest.approx(jl, rel=1e-2)
