"""Spatially partitioned U-Net training (``syconn_tpu_torch/parallel/spatial.py``
and ``models/train.py``'s ``sp`` axis) on logical CPU meshes, against the
port's unsharded modules and single-device step, and against the JAX
package's single-device ``train_dense``.

Tolerances:

* the sharded convolutions and the whole ``UNet3D`` forward equal the
  unsharded ones bit for bit (each shard computes the same products on the
  same bf16 operands; the halo zeros are the SAME pads' zeros);
* their gradients flow through bf16 activations: summed in another order
  they round a few bf16 ulps (2^-8 relative) apart, so each gradient of a
  conv alone is held within 1e-2 of its largest magnitude, and each
  parameter's gradient through the whole U-Net (ten bf16 layers) within
  2e-2;
* the step on a data x sp (x tp) mesh: three steps against the
  single-device step from the same state, as tests/test_torch_parallel.py
  holds the data x tp step: loss within 1e-4 relative, ``acc`` within 1e-3,
  parameters within 1e-5 at the median and 2 x lr x steps at most (AdamW
  divides each gradient by its own magnitude, so a gradient near zero,
  summed in another order, can move its parameter the other way);
* against the JAX package's single-device ``train_dense`` from the same
  initial parameters: losses within 1e-2 relative (the models compute in
  bf16; tests/test_torch_parallel.py's data-mesh test). JAX's own SPMD step
  equals its serial step up to summation order.
"""

import numpy as np
import pytest
import torch

from syconn_tpu_torch.models import train as T
from syconn_tpu_torch.models.unet3d import Conv3d, UNet3D
from syconn_tpu_torch.parallel import spatial as S
from syconn_tpu_torch.parallel.device import get_device_mesh

CPU = torch.device("cpu")
NET = dict(features=(16, 32), strides=((2, 2, 2),), patch=(2, 2, 2), n_classes=2)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _mesh(axes, shape):
    return get_device_mesh(axis_names=axes, mesh_shape=shape, devices=[CPU] * int(np.prod(shape)))


def _within(got, want, rel=1e-2):
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    assert scale > 0 and float((got - want).abs().max()) <= rel * scale


# ------------------------------------------------------------- the split rule
@pytest.mark.parametrize("z, n, unit, want", [
    (16, 2, 4, [8, 8]), (16, 4, 4, [4, 4, 4, 4]), (24, 4, 4, [8, 8, 4, 4]),
    (32, 4, 8, [8, 8, 8, 8]), (40, 3, 8, [16, 16, 8]), (4, 1, 4, [4])])
def test_split_extents(z, n, unit, want):
    assert S.split_extents(z, n, unit) == want
    t = torch.arange(2 * z).reshape(1, 1, 1, z, 2)
    parts = S.split_z(t, n, unit)
    assert [p.shape[3] for p in parts] == want and torch.equal(torch.cat(parts, 3), t)


@pytest.mark.parametrize("z, n, unit", [(10, 2, 4), (12, 4, 4), (4, 2, 4), (0, 1, 4)])
def test_split_extents_raises(z, n, unit):
    with pytest.raises(ValueError, match=f"f = {unit}"):
        S.split_extents(z, n, unit)


def test_z_unit():
    assert S.z_unit(UNet3D(**NET)) == 4
    assert S.z_unit(UNet3D(**dict(NET, strides=((2, 2, 1),)))) == 2
    assert S.z_unit(UNet3D(features=(4, 8, 16), strides=((2, 2, 2), (2, 2, 2)),
                           patch=(4, 4, 2))) == 8


# ------------------------------------------------------ each conv form alone
FORMS = {  # (transpose, stride): (halo before, halo after), z zeros of the haloed shard
    "3x3x3": ((False, (1, 1, 1)), (1, 1), (0, 0)),
    "down z2": ((False, (2, 2, 2)), (0, 1), (0, 0)),
    "down z1": ((False, (2, 2, 1)), (1, 1), (0, 0)),
    "transpose z2": ((True, (2, 2, 2)), (1, 0), (0, 1)),
    "transpose z1": ((True, (2, 2, 1)), (1, 1), (0, 0)),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_z_halo_widths(form):
    (transpose, stride), halo, zeros = FORMS[form]
    conv = Conv3d(4, 6, stride=stride, transpose=transpose)
    assert S.z_halo(conv, 16) == (halo, zeros)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("form", list(FORMS))
def test_sharded_conv_matches_unsharded(form, n):
    """Forward equal; input, weight and bias gradients within 1e-2 of their
    largest magnitude."""
    (transpose, stride), _, _ = FORMS[form]
    g = torch.Generator().manual_seed(3)
    conv = Conv3d(4, 6, stride=stride, transpose=transpose)
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.2, generator=g)
        conv.bias.normal_(0.0, 0.2, generator=g)
    x0 = torch.randn((1, 8, 8, 16, 4), generator=g).to(torch.bfloat16)
    x = x0.clone().requires_grad_()
    ref = conv(x)
    gy = torch.randn(ref.shape, generator=g).to(torch.bfloat16)
    want = torch.autograd.grad(ref, [x, conv.weight, conv.bias], gy)
    xs = x0.clone().requires_grad_()
    out = torch.cat(S.sharded_conv([conv] * n, list(torch.split(xs, 16 // n, dim=3))), dim=3)
    assert out.shape == ref.shape and torch.equal(out, ref)
    for a, b in zip(torch.autograd.grad(out, [xs, conv.weight, conv.bias], gy), want):
        _within(a, b)


def test_sharded_conv_raises_on_odd_shards():
    with pytest.raises(ValueError, match="z stride 2"):
        S.sharded_conv([Conv3d(2, 2, stride=(2, 2, 2))] * 2,
                       list(torch.split(torch.zeros(1, 4, 4, 6, 2), [3, 3], dim=3)))


def test_halo_exchange_z_moves_gradients_to_the_neighbours():
    from syconn_tpu_torch.parallel.halo import halo_exchange

    t = torch.arange(12.0).reshape(1, 1, 1, 6, 2).requires_grad_()
    a, b = halo_exchange(list(torch.split(t, 3, dim=3)), 1, 2, dim=3, edge_mode="zero")
    assert torch.equal(a[0, 0, 0, :, 0], torch.tensor([0.0, 0, 2, 4, 6, 8]))
    assert torch.equal(b[0, 0, 0, :, 0], torch.tensor([4.0, 6, 8, 10, 0, 0]))
    (g,) = torch.autograd.grad(a.sum() + b.sum(), [t])
    assert g[0, 0, 0, :, 0].tolist() == [1.0, 1, 2, 2, 2, 1]
    with pytest.raises(ValueError, match="wider than shard"):
        halo_exchange(list(torch.split(t, [1, 5], dim=3)), 2, 0, dim=3, edge_mode="zero")


# --------------------------------------------------------- the whole forward
@pytest.mark.parametrize("strides, z, n", [
    (((2, 2, 2),), 16, 2), (((2, 2, 2),), 16, 4), (((2, 2, 1),), 16, 4),
    (((2, 2, 2),), 24, 4)])  # the last: units of 4 as 2, 2, 1, 1
def test_unet_forward_matches_unsharded(strides, z, n):
    model = UNet3D(**dict(NET, strides=strides))
    rng = np.random.default_rng(z + n)
    x = torch.from_numpy(rng.integers(0, 255, (2, 16, 16, z, 1)).astype(np.float32))
    ref = model(x)
    parts = S.split_z(x, n, S.z_unit(model))
    out = S.unet_forward([model] * n, parts)
    assert [o.shape[3] for o in out] == [p.shape[3] for p in parts]
    assert torch.equal(torch.cat(out, dim=3), ref)
    packed = torch.cat(S.unet_forward([model] * n, parts, full_res=False), dim=3)
    assert torch.equal(packed, model(x, full_res=False))
    params = list(model.parameters())
    want = torch.autograd.grad(ref.square().mean(), params)
    got = torch.autograd.grad(torch.cat(S.unet_forward([model] * n, parts), 3).square().mean(),
                              params)
    for a, b in zip(got, want):
        _within(a, b, rel=2e-2)


# ------------------------------------------------------------------ the step
def _state():
    return T.make_train_state(UNet3D(**NET), None, learning_rate=1e-3, seed=0, device="cpu")


def _params(state):
    return {k: v.detach().clone() for k, v in state.model.named_parameters()}


@pytest.mark.parametrize("axes, shape", [
    (("data", "sp"), (4, 2)), (("data", "sp"), (2, 2)), (("data", "sp"), (1, 4)),
    (("data", "sp", "tp"), (2, 2, 2))])  # the last: the JAX package's dry-run mesh
def test_spatial_step_matches_single_device(monkeypatch, axes, shape):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, (4, 16, 16, 16, 1)).astype(np.float32)
    y = (x[..., 0] > 127).astype(np.int64)
    y[0, :2] = -1
    loss_fn = T.weighted_xent([1.0, 2.0])
    calls = []
    forward = S.unet_forward
    monkeypatch.setattr(S, "unet_forward", lambda ms, xs, **kw: calls.append(len(xs))
                        or forward(ms, xs, **kw))
    single, sharded = _state(), _state()
    mesh = _mesh(axes, shape)
    step1 = T.make_train_step(loss_fn=loss_fn)
    stepm = T.make_train_step(mesh, tensor_axis="tp", state_template=sharded, loss_fn=loss_fn)
    for _ in range(3):
        single, m1 = step1(single, x, y)
        sharded, m2 = stepm(sharded, x, y)
        assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-4)
        assert abs(float(m2["acc"]) - float(m1["acc"])) <= 1e-3
    assert calls == [shape[1]] * (3 * shape[0])  # every forward ran sharded
    a, b = _params(single), _params(sharded)
    diff = np.concatenate([(a[k] - b[k]).abs().numpy().ravel() for k in a])
    assert np.median(diff) <= 1e-5 and diff.max() <= 2 * 1e-3 * 3
    pl = sharded.placement
    assert [len(r) for r in pl.positions] == [shape[1]] * shape[0]
    assert bool(pl.shards) == ("tp" in axes) and sharded.step == 3


def test_spatial_step_raises():
    """A z that does not split raises ``ValueError`` before any work; a
    model that is not a U-Net raises ``TypeError``; neither steps."""
    from syconn_tpu_torch.models.pointnet import PointClassNet

    mesh = _mesh(("data", "sp"), (1, 4))
    state = _state()
    before = _params(state)
    step = T.make_train_step(mesh)
    for z in (12, 18):  # 3 units of 4 for 4 shards; no multiple of 4
        x = np.zeros((2, 16, 16, z, 1), np.float32)
        with pytest.raises(ValueError, match="f = 4"):
            step(state, x, np.zeros(x.shape[:4], np.int64))
    assert state.step == 0 and all(torch.equal(before[k], v) for k, v in _params(state).items())
    pstate = T.make_train_state(PointClassNet(n_classes=2, widths=(8, 12), k=4), None,
                                device="cpu")
    with pytest.raises(TypeError, match="UNet3D"):
        T.make_train_step(mesh)(pstate, np.zeros((2, 16, 7), np.float32), np.zeros(2, np.int64))


def test_train_dense_spatial_matches_jax_single_device():
    """``train_dense(mesh=data 2 x sp 2)`` of the port against the JAX
    package's single-device ``train_dense`` from the same initial params."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from syconn_tpu.models import train as J
    from syconn_tpu.models.unet3d import UNet3D as JU
    from syconn_tpu_torch.models.convert import module_state_from_flax

    kw = dict(features=(8, 16), strides=((2, 2, 2),), patch=(2, 2, 2), n_classes=2)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 255, (2, 16, 16, 8, 1)).astype(np.float32) for _ in range(3)]
    batches = [(x, (x[..., 0] > 127).astype(np.int32)) for x in batches]
    jstate = J.make_train_state(JU(**kw), (1, 16, 16, 8, 1), learning_rate=1e-3)
    model = UNet3D(**kw)
    tstate = T.make_train_state(model, None, learning_rate=1e-3, device="cpu")
    model.load_state_dict(module_state_from_flax(
        jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jstate.params)))
    _, jh = J.train_dense(JU(**kw), iter([(jnp.asarray(x), jnp.asarray(y)) for x, y in batches]),
                          3, (1, 16, 16, 8, 1), state=jstate, log_every=1)
    _, th = T.train_dense(model, iter(batches), 3, None, mesh=_mesh(("data", "sp"), (2, 2)),
                          state=tstate, log_every=1)
    assert [len(r) for r in tstate.placement.positions] == [2, 2]
    assert [h[0] for h in th] == [1, 2, 3]
    for (_, jl, _), (_, tl, _) in zip(jh, th):
        assert tl == pytest.approx(jl, rel=1e-2)
