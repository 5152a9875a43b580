"""The port's view nets (``syconn_tpu_torch/models/cmn.py``) against the JAX
package's flax modules (``syconn_tpu/models/cmn.py``) on the CPU, on the
same parameters and inputs, flax ``apply`` run eagerly:

* single layers: the bf16 ``Conv`` (3x3 SAME, stride 1 and 2, even and odd
  extents) and ``ConvTranspose`` (3x3, stride 2, even and odd extents),
  without bias, at most two bf16 ulps apart (one rounding step, which can
  cross a binade) on fewer than 1e-3 of the values (f32 sums in another
  order round some sums the other way; a bias added afterwards can make
  that step more than one ulp of the result); ``GroupNorm`` (8 groups, f32)
  within 2e-4;
* the three nets at the inference functions' widths (16, 32, 64) with JAX-initialised
  weights on seeded uint8-range views at 128x64 and small extents: within
  the dense budgets of ROADMAP.md (median relative error < 3e-2, argmax
  flips < 2e-2 at random init; the GroupNorm statistics' f32 sums in
  another order than XLA's flip bf16 roundings, which the following layers
  carry);
* the writer: ``msgpack_serialize`` gives flax's ``to_bytes`` bytes;
  ``save_model`` of a seed-initialised port net is read by the JAX
  package's ``load_model``, whose forward agrees with the port's as above;
* the seed initialisation: every kernel's mean and std against flax's
  ``lecun_normal`` at the same shape (std within 15%, mean within four
  standard errors), biases 0, scales 1, and ``get_or_init_model``'s
  resolution order.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from syconn_tpu.models import cmn as J  # noqa: E402
from syconn_tpu_torch.models import cmn as T  # noqa: E402
from syconn_tpu_torch.models.convert import module_state_from_flax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np_tree(params):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)


def _jax_apply(module, params, x):
    with jax.disable_jit():
        return np.asarray(module.apply({"params": params}, jnp.asarray(x)), np.float32)


def _torch_apply(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(np.ascontiguousarray(x))).float().numpy()


def _one_bf16_rounding_apart(a, b, share=1e-3):
    neq = a != b
    assert neq.mean() < share, neq.mean()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(a), np.abs(b)) + 1e-30)) - 7)
    assert (np.abs(a - b)[neq] <= 2 * ulp[neq]).all()


def _dense_budget(got, ref, flips=2e-2):
    assert got.shape == ref.shape and np.isfinite(got).all()
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-2)
    assert np.median(rel) < 3e-2, np.median(rel)
    assert np.mean(got.argmax(-1) != ref.argmax(-1)) < flips


@pytest.mark.parametrize("hw,cin,cout,stride,transpose", [
    ((128, 64), 4, 16, 2, False), ((9, 13), 4, 16, 2, False), ((16, 8), 64, 64, 1, False),
    ((7, 5), 16, 32, 1, False), ((16, 8), 64, 32, 2, True), ((7, 5), 32, 16, 2, True),
])
def test_conv_layers_equal_flax(hw, cin, cout, stride, transpose):
    rng = np.random.default_rng(cin + cout + stride)
    x = rng.normal(size=(3,) + hw + (cin,)).astype(jnp.bfloat16)
    cls = nn.ConvTranspose if transpose else nn.Conv
    m = cls(cout, (3, 3), strides=(stride, stride), padding="SAME", dtype=jnp.bfloat16)
    p = _np_tree(m.init(jax.random.PRNGKey(stride), jnp.zeros((1,) + hw + (cin,)))["params"])
    ref = _jax_apply(m, p, x)
    t = T.Conv2d(cin, cout, stride=stride, transpose=transpose)
    sd = module_state_from_flax({"c": p})
    t.load_state_dict({"weight": sd["c.weight"], "bias": sd["c.bias"]})
    with torch.no_grad():
        got = t(torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)).float().numpy()
    out_hw = tuple(n * 2 for n in hw) if transpose else tuple(-(-n // stride) for n in hw)
    assert got.shape == ref.shape == (3,) + out_hw + (cout,)
    _one_bf16_rounding_apart(got, ref)


@pytest.mark.parametrize("hw,c", [((64, 32), 16), ((5, 3), 16), ((16, 8), 64)])
def test_group_norm_equal_flax(hw, c):
    rng = np.random.default_rng(c)
    x = (rng.normal(size=(4,) + hw + (c,)) * 3 + 1).astype(jnp.bfloat16)
    m = nn.GroupNorm(num_groups=8, dtype=jnp.float32)
    p = {"scale": rng.normal(size=c).astype(np.float32), "bias": rng.normal(size=c).astype(np.float32)}
    ref = _jax_apply(m, p, x)
    t = T.GroupNorm(c)
    t.load_state_dict({"scale": torch.from_numpy(p["scale"]), "bias": torch.from_numpy(p["bias"])})
    with torch.no_grad():
        got = t(torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


def _nets(n_in=4):
    return {
        "celltype": (J.MultiViewCMN(n_classes=8, widths=(16, 32, 64)),
                     T.MultiViewCMN(n_classes=8, widths=(16, 32, 64), n_in=n_in), True),
        "glia": (J.MultiViewCMN(n_classes=2, widths=(16, 32, 64)),
                 T.MultiViewCMN(n_classes=2, widths=(16, 32, 64), n_in=n_in), True),
        "tnet": (J.TripletCMN(embed_dim=10, widths=(16, 32, 64)),
                 T.TripletCMN(embed_dim=10, widths=(16, 32, 64), n_in=n_in), True),
        "semseg": (J.ViewSemSegNet(n_classes=3, widths=(16, 32, 64)),
                   T.ViewSemSegNet(n_classes=3, widths=(16, 32, 64), n_in=n_in), False),
    }


def _views(stack, hw, seed, b=8):
    rng = np.random.default_rng(seed)
    shape = (b, 2) + hw + (4,) if stack else (b,) + hw + (4,)
    x = rng.integers(0, 256, size=shape).astype(np.float32)
    x[rng.random(shape) < 0.5] = 255  # background, as rendered views hold
    return x


@pytest.mark.parametrize("name", ["celltype", "glia", "tnet", "semseg"])
@pytest.mark.parametrize("hw", [(128, 64), (16, 8), (10, 6)])
def test_view_nets_equal_flax(name, hw):
    jm, tm, stack = _nets()[name]
    if name == "semseg" and hw == (10, 6):
        hw = (12, 8)  # the U-Net's skips need extents divisible by 4 (in flax too)
    x = _views(stack, hw, seed=len(name) + hw[0])
    params = _np_tree(jm.init(jax.random.PRNGKey(1), jnp.zeros((1,) + x.shape[1:]))["params"])
    tm.load_state_dict(module_state_from_flax(params))
    ref = _jax_apply(jm, params, x)
    got = _torch_apply(tm, x)
    _dense_budget(got, ref)
    if name == "tnet":
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_msgpack_serialize_is_flax_bytes():
    from flax import serialization

    from syconn_tpu_torch.models.msgpack_io import msgpack_restore, msgpack_serialize

    rng = np.random.default_rng(0)
    jm = J.ViewSemSegNet(n_classes=3, widths=(16, 32, 64))
    tree = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 8, 4)))["params"])
    tree["extra"] = {"ints": np.arange(300, dtype=np.int64), "scalar": np.float32(2.5),
                     "u8": rng.integers(0, 255, 70000).astype(np.uint8),
                     "empty": np.zeros((0, 3), np.float32)}
    raw = msgpack_serialize(tree)
    assert raw == serialization.to_bytes(tree)
    back = msgpack_restore(raw)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["celltype", "tnet", "semseg"])
def test_port_model_dir_read_by_jax(tmp_path, name):
    """A seed-initialised port net saved by ``save_model``: the JAX package's
    ``load_model`` reads it and its forward agrees with the port's."""
    from syconn_tpu.models import io as jio
    from syconn_tpu_torch.models import io as tio

    if name == "semseg":  # the JAX package's loader does not name this class
        jio.register_model("ViewSemSegNet")(J.ViewSemSegNet)
    _, tm, stack = _nets()[name]
    params = tio.init_model_params(tm, seed=3)
    path = str(tmp_path / name)
    tio.save_model(path, tm, params, extra_meta={"initialized_only": True, "seed": 3})
    jm, jp = jio.load_model(path)
    assert type(jm).__name__ == type(tm).__name__
    assert jio.load_model_meta(path) == {"initialized_only": True, "seed": 3}
    x = _views(stack, (128, 64), seed=7)
    ref = np.asarray(_jax_apply(jm, jp, x))
    _dense_budget(_torch_apply(tm, x), ref)
    # and the port reads its own directory back to the same module
    tm2, p2 = tio.load_model(path)
    np.testing.assert_array_equal(_torch_apply(tm2, x), _torch_apply(tm, x))


def test_init_statistics_match_flax():
    from syconn_tpu_torch.models.io import init_model_params

    for name, (jm, tm, stack) in _nets().items():
        shape = (1, 2, 128, 64, 4) if stack else (1, 128, 64, 4)
        jp = jax.tree_util.tree_leaves_with_path(_np_tree(
            jm.init(jax.random.PRNGKey(0), jnp.zeros(shape))["params"]))
        tp = init_model_params(tm, seed=0)
        flat_t = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(tp)}
        assert sorted(flat_t) == sorted(jax.tree_util.keystr(k) for k, _ in jp)
        for k, a in jp:
            b = flat_t[jax.tree_util.keystr(k)]
            assert a.shape == b.shape, k
            leaf = jax.tree_util.keystr(k)
            if "kernel" in leaf:
                fan_in = int(np.prod(a.shape[:-1]))
                bound = 2.0 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
                assert np.abs(b).max() <= bound * (1 + 1e-6)
                assert abs(b.std() / a.std() - 1) < 0.15, (leaf, b.std(), a.std())
                assert abs(b.mean()) < 4 * a.std() / np.sqrt(a.size), leaf
            elif "scale" in leaf:
                assert (b == 1).all()
            else:
                assert (b == 0).all()
        # the same seed draws the same weights
        np.testing.assert_array_equal(
            jax.tree_util.tree_leaves(init_model_params(tm, seed=0))[0],
            jax.tree_util.tree_leaves(tp)[0])


def test_get_or_init_model_resolution(tmp_path):
    from syconn_tpu_torch.models import io as tio

    path = str(tmp_path / "celltype")
    build = lambda: T.MultiViewCMN(n_classes=8, widths=(16, 32, 64))  # noqa: E731
    with pytest.raises(FileNotFoundError, match="allow_untrained_models"):
        tio.get_or_init_model(path, build, require_trained=True)
    assert not os.path.exists(path)
    m, p = tio.get_or_init_model(path, build, seed=5)
    with open(os.path.join(path, "arch.json")) as f:
        arch = json.load(f)
    assert arch["cls"] == "MultiViewCMN" and arch["meta"] == {"initialized_only": True, "seed": 5}
    assert arch["kwargs"] == {"n_classes": 8, "widths": [16, 32, 64], "n_scalar": 0,
                              "dtype": "bfloat16"}
    m2, p2 = tio.get_or_init_model(path, lambda: pytest.fail("must load"), require_trained=True)
    x = _views(True, (16, 8), seed=1, b=2)
    np.testing.assert_array_equal(_torch_apply(m2, x), _torch_apply(m, x))
    # a packaged net of the same name is the fallback
    pm, _ = tio.get_or_init_model(str(tmp_path / "glia_pts"), lambda: pytest.fail("packaged"))
    assert type(pm).__name__ == "PointSegNet"
