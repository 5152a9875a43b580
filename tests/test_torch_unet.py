"""The port's UNet3D module and engine against flax and the JAX engine, on the
packaged syntype and myelin weights at full width.

Tolerances (tests/test_conv_pallas.py:100-164): packed logits median
relative error < 3e-2 (floor 0.05); argmax flips < 2e-2; on trained
weights, thresholded-mask flips < 3e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syconn_tpu.models import io as jio
from syconn_tpu.models import unet3d as junet
from syconn_tpu.models import unet_engine as jengine
from syconn_tpu_torch.models import io as tio
from syconn_tpu_torch.models import unet3d as tunet
from syconn_tpu_torch.models import unet_engine as tengine
from syconn_tpu_torch.models.convert import params_from_flax

_CACHE = {}


def _load(name):
    if name not in _CACHE:
        jm, jp = jio.load_model(jio.packaged_model_path(name))
        tm, tp = tio.load_model(tio.packaged_model_path(name))
        _CACHE[name] = (jm, jp, tm, params_from_flax(tp, "cpu"))
    return _CACHE[name]


def _x(seed=7):
    return np.random.default_rng(seed).integers(0, 255, size=(1, 32, 32, 16, 1)).astype(np.float32)


def _check_logits(got, ref, n_classes):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 0.05)
    assert np.median(rel) < 3e-2, float(np.median(rel))
    pv = ref.shape[-1] // n_classes
    ra = ref.reshape(ref.shape[:-1] + (n_classes, pv)).argmax(-2)
    ga = got.reshape(got.shape[:-1] + (n_classes, pv)).argmax(-2)
    assert np.mean(ra != ga) < 2e-2, float(np.mean(ra != ga))


@pytest.mark.parametrize("p", [(4, 4, 2), (2, 2, 2), (1, 2, 3)])
def test_space_depth_bit_exact(p):
    x = np.random.default_rng(0).normal(size=(2, 12, 8, 6, 3)).astype(np.float32)
    ref = np.asarray(junet.space_to_depth(jnp.asarray(x), p))
    got = tunet.space_to_depth(torch.from_numpy(x), p).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tunet.depth_to_space(torch.from_numpy(np.array(ref)), p).numpy(),
                                  np.asarray(junet.depth_to_space(jnp.asarray(ref), p)))


@pytest.mark.parametrize("name", ["syntype", "myelin"])
def test_module_matches_flax(name):
    jm, jp, tm, _ = _load(name)
    x = _x()
    ref = np.asarray(jm.apply({"params": jp}, jnp.asarray(x), full_res=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), full_res=False).numpy()
        full = tm(torch.from_numpy(x)).numpy()
    _check_logits(got, ref, jm.n_classes)
    assert full.shape == (1, 32, 32, 16, jm.n_classes)
    np.testing.assert_array_equal(
        full, tunet.packed_to_full(torch.from_numpy(got), jm.n_classes, jm.patch).numpy())


@pytest.mark.parametrize("name", ["syntype", "myelin"])
@pytest.mark.parametrize("up,down,fused", [
    (u, d, f) for u in (True, False) for d in (True, False) for f in (True, False)])
def test_engine_matches_jax_engine_every_toggle(name, up, down, fused, monkeypatch):
    """Port engine vs ``syconn_tpu.models.unet_engine.unet_apply_packed``
    (interpret mode) under the same UP_PHASES/DOWN_PHASES/FUSED_HEAD."""
    jm, jp, tm, tp = _load(name)
    for k, v in (("UP_PHASES", up), ("DOWN_PHASES", down), ("FUSED_HEAD", fused)):
        monkeypatch.setenv(f"SYCONN_TPU_ENGINE_{k}", "1" if v else "0")
    x = _x()
    ref = np.asarray(jengine.unet_apply_packed(jm, jp, jnp.asarray(x), interpret=True))
    got = tengine.unet_apply_packed(tm, tp, torch.from_numpy(x), up_phases=up,
                                    down_phases=down, fused_head=fused).numpy()
    _check_logits(got, ref, jm.n_classes)


@pytest.mark.parametrize("name", ["syntype", "myelin"])
def test_engine_trained_mask_agreement(name):
    """Thresholded masks of the trained weights agree with the JAX engine
    on > 99.7% of voxels, and the full-res output matches its layout."""
    jm, jp, tm, tp = _load(name)
    x = _x(11)
    ref = np.asarray(jengine.unet_apply_packed(jm, jp, jnp.asarray(x), interpret=True))
    got = tengine.unet_apply_packed(tm, tp, torch.from_numpy(x)).numpy()
    C = jm.n_classes
    pv = ref.shape[-1] // C
    rp = np.asarray(jax.nn.softmax(ref.reshape(ref.shape[:-1] + (C, pv)), axis=-2))
    gp = torch.softmax(torch.from_numpy(got.reshape(got.shape[:-1] + (C, pv))), -2).numpy()
    flips = np.mean((rp >= 0.5) != (gp >= 0.5))
    assert flips < 3e-3, float(flips)
    full = tengine.unet_apply_full(tm, tp, torch.from_numpy(x)).numpy()
    lg = np.moveaxis(got.reshape(got.shape[:-1] + (C, pv)), -2, -1).reshape(got.shape)
    np.testing.assert_array_equal(full, np.asarray(junet.depth_to_space(jnp.asarray(lg), jm.patch)))


def test_unet_flops_matches_jax():
    for name in ("syntype", "myelin", "organelles"):
        kw = junet.unet_variants(name)
        assert tengine.unet_flops(tunet.UNet3D(**tunet.unet_variants(name)), (1, 320, 320, 160)) \
            == jengine.unet_flops(junet.UNet3D(**kw), (1, 320, 320, 160))
        assert tunet.unet_variants(name) == kw


def test_engine_odd_extents_and_strides_take_the_same_kernel():
    """Odd extents and non-2 strides run the SAME conv (stuffed / sliced)
    and agree with the flax-semantics module."""
    m = tunet.UNet3D(features=(16, 32), strides=((2, 2, 1),), patch=(2, 2, 2), n_classes=2)
    tree = {}
    for k, v in m.state_dict().items():
        *path, leaf = k.split(".")
        d = tree
        for p in path:
            d = d.setdefault(p, {})
        v = v.numpy()
        if leaf == "weight":
            d["kernel"] = np.transpose(v, (2, 3, 4, 1, 0))
        else:
            d[leaf] = v
    tp = params_from_flax(tree, "cpu")
    x = torch.from_numpy(np.random.default_rng(2).integers(0, 255, (1, 12, 20, 10, 1)).astype(np.float32))
    with torch.no_grad():
        ref = m(x, full_res=False).numpy()
    got = tengine.unet_apply_packed(m, tp, x).numpy()
    _check_logits(got, ref, 2)
