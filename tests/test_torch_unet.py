"""The port's UNet3D module and engine against flax and the JAX engine, on
every packaged dense U-Net (syntype, myelin, organelles, er, golgi) at full
width.

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
DENSE = ["syntype", "myelin", "organelles", "er", "golgi"]
# the full toggle grid on two nets, the default toggles on the others (ids
# "<up>-<down>-<fused>-<name>")
TOGGLES = [pytest.param(n, u, d, f, id=f"{u}-{d}-{f}-{n}")
           for n in ("syntype", "myelin") for u in (True, False) for d in (True, False)
           for f in (True, False)]
TOGGLES += [pytest.param(n, True, True, True, id=f"True-True-True-{n}")
            for n in ("organelles", "er", "golgi")]


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


@pytest.mark.parametrize("name", DENSE)
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


@pytest.mark.parametrize("name,up,down,fused", TOGGLES)
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


@pytest.mark.parametrize("name", DENSE)
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


def _lsb_share(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return float(np.mean(d <= 2)), int(d.max()), float(np.mean(a.argmax(-1) == b.argmax(-1)))


def test_organelles_port_within_the_reference_spread(monkeypatch):
    """Why the organelles U-Net has a budget of its own: on the reference
    input of ``chip_smoke.py::phase_reference`` (uniform noise 64 x 64 x 32,
    tile (64, 64, 32), halo (16, 16, 8), probs mode) the JAX package's two
    implementations of the same net, flax ``apply`` (its CPU predictor) and
    its Pallas engine (interpret mode), are themselves only this close:
    the uint8 maps agree within 2 LSB on far fewer than 99.9% of voxels.
    The port's plain path, the JAX engine's counterpart, must be as close
    to the JAX engine as flax is, to within 0.1% of voxels, in both the
    2-LSB share and the argmax. Run with ``-s`` to print the shares
    (chip_smoke.py's organelles budget comes from them)."""
    from syconn_tpu.inference import dense as jdense
    from syconn_tpu_torch.inference import dense as tdense

    jm, jp, tm, _ = _load("organelles")
    _, tparams_ = tio.load_model(tio.packaged_model_path("organelles"))
    vol = np.random.default_rng(1).integers(0, 256, (64, 64, 32), dtype=np.uint8)
    kw = dict(tile_shape=(64, 64, 32), halo=(16, 16, 8), mode="probs")
    monkeypatch.delenv("SYCONN_TPU_PALLAS_CONV", raising=False)
    flax = jdense.DenseTilePredictor(jm, jp, **kw).predict_array(vol)
    monkeypatch.setenv("SYCONN_TPU_PALLAS_CONV", "1")
    engine = jdense.DenseTilePredictor(jm, jp, **kw).predict_array(vol)
    port = tdense.DenseTilePredictor(tm, tparams_, device="cpu", **kw).predict_array(vol)
    ref = _lsb_share(engine, flax)
    got = _lsb_share(port, flax)
    print(f"\norganelles, JAX engine vs flax: within 2 LSB {ref[0]:.5f}, max {ref[1]} LSB, "
          f"argmax stable {ref[2]:.5f}; port plain vs flax: {got[0]:.5f}, {got[1]}, {got[2]:.5f}; "
          f"port plain vs JAX engine: {_lsb_share(port, engine)}")
    pair = _lsb_share(port, engine)
    assert ref[0] < 0.999  # the reference misses the syntype budget against itself
    assert pair[0] >= ref[0] - 1e-3 and pair[2] >= ref[2] - 1e-3, (pair, ref)
    assert got[2] >= ref[2] - 1e-3


def test_engine_trace_feed_and_layer_report():
    """The engine's per-layer trace names every conv layer, a layer fed its
    own traced input reproduces its output, and the per-layer report of two
    CPU runs finds no difference (on the card it compares with the CPU)."""
    from syconn_tpu_torch.tools.engine_layers import layer_report

    _, _, tm, tp = _load("organelles")
    x = torch.from_numpy(_x(3)[:, :16, :16, :8])
    trace = []
    out = tengine.unet_apply_packed(tm, tp, x, trace=trace)
    names = [n for n, _, _ in trace]
    assert names == ["enc0_conv0", "enc0_conv1", "down0", "enc1_conv0", "enc1_conv1", "up0",
                     "dec0_conv0", "head"]
    assert torch.equal(trace[-1][2], out) and trace[0][1].shape[-1] == 8
    fed = []
    tengine.unet_apply_packed(tm, tp, torch.zeros_like(x), feed={"up0": trace[5][1]}, trace=fed)
    assert torch.equal(fed[5][2], trace[5][2])
    rows = layer_report(tm, tp, tp, x[0, ..., 0].numpy().astype(np.uint8), "cpu")
    assert [r["layer"] for r in rows] == names + ["softmax_round"]
    assert all(r["alone"]["max_abs"] == 0 == r["chained"]["max_abs"] for r in rows[:-1])
    assert rows[-1]["max_lsb"] == 0


def test_ln_gelu_epilogue_follows_the_jax_formula():
    """The port's LayerNorm + GELU epilogue (``ops/conv3d.py::_ln_gelu``), on
    the pre-LN values of the JAX kernel itself (Pallas interpret mode, the
    organelles net's second conv), equals the JAX kernel's formula evaluated
    eagerly on >= 99.9% of the bf16 outputs. Run with ``-s`` to print how far
    the interpret-mode kernel's own epilogue lies from that formula."""
    from syconn_tpu.ops import conv3d_pallas as J
    from syconn_tpu_torch.ops.conv3d import _ln_gelu

    jm, jp, tm, tp = _load("organelles")
    trace = []
    tengine.unet_apply_packed(tm, tp, torch.from_numpy(_x(3)), trace=trace)
    inp = jnp.asarray(trace[1][1].float().numpy()).astype(jnp.bfloat16)  # enc0_conv1's input
    p, ln = jp["ConvBlock_0"]["Conv_1"], jp["ConvBlock_0"]["LayerNorm_1"]
    args = (inp, p["kernel"], p["bias"], ln["scale"], ln["bias"])
    hb = J.conv3x3x3_ln_gelu(*args, interpret=True, epilogue="bias").astype(jnp.float32)
    kernel = np.asarray(J.conv3x3x3_ln_gelu(*args, interpret=True).astype(jnp.float32))
    mu = jnp.mean(hb, axis=-1, keepdims=True)
    var = jnp.mean(hb * hb, axis=-1, keepdims=True) - mu * mu
    y = (hb - mu) * jax.lax.rsqrt(var + 1e-6) * ln["scale"] + ln["bias"]
    eager = np.asarray(jax.nn.gelu(y).astype(jnp.bfloat16).astype(jnp.float32))
    port = _ln_gelu(torch.from_numpy(np.array(hb)), torch.from_numpy(np.array(ln["scale"])),
                    torch.from_numpy(np.array(ln["bias"]))).to(torch.bfloat16).float().numpy()
    print(f"\nLN+GELU epilogue, share of bf16 outputs differing: port vs eager JAX formula "
          f"{np.mean(port != eager):.6f}; JAX interpret-mode kernel vs the same formula "
          f"{np.mean(kernel != eager):.6f}")
    assert np.mean(port == eager) >= 0.999
