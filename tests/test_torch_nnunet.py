"""nnU-Net 3d_fullres on the port's dense path, on the CPU: the engine
(``models/nnunet_engine.py``, every op's plain version) against the plain
float32 reference (``models/nnunet_ref.py``: ``nn.Conv3d``,
``nn.ConvTranspose3d``, ``nn.InstanceNorm3d``, ``nn.LeakyReLU``) on seeded
weights, at a small size that keeps every kind of layer (the one-channel
stem, the (1, 1)-padded stride-2 convs, the kernel-2 stride-2 transposes,
``cat(up, skip)``, InstanceNorm + LeakyReLU, the 1x1 head); the norm's plain
version against PyTorch's functional ops; nnU-Net's padding rule; the model
through both dense predictors; and the U-Net's route through the predictor's
engine seam. The kernels are held to their plain versions on the card
(``tests/test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from syconn_tpu_torch.inference import dense
from syconn_tpu_torch.inference.dense import (DenseTilePredictor, ResidentDensePredictor,
                                              engine_of)
from syconn_tpu_torch.models import nnunet_engine as E
from syconn_tpu_torch.models.nnunet import NNUNet
from syconn_tpu_torch.models.nnunet_ref import PlainConvUNetRef
from syconn_tpu_torch.ops import instnorm as IN

# three stages (strides 1, 2, 2: every kind of layer), four classes; a mean
# that is a whole uint8 value, so that raw voxels of that value z-score to 0
TINY = dict(features=(8, 16, 32), strides=((1, 1, 1), (2, 2, 2), (2, 2, 2)), n_classes=4,
            intensity_mean=128.0, intensity_std=40.0)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    model = NNUNet(**TINY)
    params = model.init_params(3)
    return model, params, PlainConvUNetRef(model).load_params(params)


def _raw(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)


def _engine_logits(model, params, window):
    """window (X, Y, Z) uint8 -> (C, X, Y, Z) f32 through the engine."""
    lg = E.nnunet_apply_packed(model, E.device_params(params, "cpu"), window[None, ..., None])
    return lg[0].permute(3, 0, 1, 2)


def _probs_u8(lg):
    return torch.round(torch.softmax(lg, dim=0) * 255.0).to(torch.uint8)


def _round_mantissa(y: torch.Tensor, bits: int) -> torch.Tensor:
    """y rounded to ``bits`` significant bits (bf16 keeps 8)."""
    m, e = torch.frexp(y.float())
    return torch.ldexp(torch.round(m * 2.0 ** bits) / 2.0 ** bits, e)


# The engine rounds every activation to bf16 (8 significant bits: 2^-9
# relative), the conv outputs before the bias and again after it, and takes
# the conv biases in bf16; the reference keeps float32 throughout. The
# instance norms re-centre every layer, so the rounding does not grow through
# the depth: at TINY the logits lie 1% of their spread off on average (9% at
# the worst voxel) and the uint8 probabilities 0.29 steps (3 at the worst).
# The limits take twice that; activations rounded to 6 significant bits, two
# below bf16, already read 4x further off and fail them.
LOGIT_MEAN, LOGIT_MAX = 0.02, 0.2     # of the reference logits' std
LSB_MEAN, LSB_MAX = 0.6, 6


def _gaps(lg, ref):
    scale = float(ref.std())
    d = (lg - ref).abs()
    p = (_probs_u8(lg).int() - _probs_u8(ref).int()).abs().float()
    return float(d.mean()) / scale, float(d.max()) / scale, float(p.mean()), float(p.max())


def test_engine_matches_the_plain_reference(tiny):
    model, params, ref = tiny
    x = _raw((16, 16, 12), 0)
    mean, mx, lsb_mean, lsb_max = _gaps(_engine_logits(model, params, x), ref(x))
    assert mean < LOGIT_MEAN and mx < LOGIT_MAX
    assert lsb_mean < LSB_MEAN and lsb_max <= LSB_MAX


def test_tolerance_fails_activations_rounded_below_bf16(tiny, monkeypatch):
    model, params, ref = tiny
    real = E.instance_norm_lrelu

    def coarse(*a, **kw):
        return _round_mantissa(real(*a, **kw), 6).to(torch.bfloat16)

    monkeypatch.setattr(E, "instance_norm_lrelu", coarse)
    x = _raw((16, 16, 12), 0)
    mean, _, lsb_mean, _ = _gaps(_engine_logits(model, params, x), ref(x))
    assert mean > LOGIT_MEAN and lsb_mean > LSB_MEAN


def test_engine_runs_every_kind_of_layer(tiny, monkeypatch):
    """One conv launch a conv (the first of stages 1 and 2 padded stride 2),
    one transpose a decoder level, one norm a conv, the skip concatenated
    after the upsampled tensor."""
    model, params, _ = tiny
    calls = []
    for name in ("conv3x3x3_ln_gelu", "conv_down2x_bias", "conv_transpose2x2_bias",
                 "instance_norm_lrelu"):
        real = getattr(E, name)

        def wrap(*a, _real=real, _name=name, **kw):
            calls.append((_name, tuple(a[0].shape), kw.get("pad_lo")))
            return _real(*a, **kw)

        monkeypatch.setattr(E, name, wrap)
    _engine_logits(model, params, _raw((16, 16, 12), 1))
    kinds = [c[0] for c in calls]
    assert kinds.count("conv3x3x3_ln_gelu") == 2 + 2 + 4 and kinds.count("conv_down2x_bias") == 2
    assert kinds.count("conv_transpose2x2_bias") == 2 and kinds.count("instance_norm_lrelu") == 10
    assert all(c[2] == 1 for c in calls if c[0] == "conv_down2x_bias")
    # the stem's one channel is padded to the kernels' 8
    assert calls[0] == ("conv3x3x3_ln_gelu", (1, 16, 16, 12, 8), None)
    # dec0 takes cat(up (16), skip (16)) at the middle stage's size
    assert ("conv3x3x3_ln_gelu", (1, 8, 8, 6, 32), None) in calls


def test_plain_norm_matches_pytorchs_instance_norm():
    g = torch.Generator().manual_seed(4)
    # an offset mean, to which a one-pass E[x^2] - mean^2 would lose digits
    x = (3.0 + 0.5 * torch.randn((2, 6, 5, 7, 16), generator=g)).to(torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn(16, generator=g)
    beta = 0.1 * torch.randn(16, generator=g)
    got = IN.instance_norm_lrelu_ref(x, gamma, beta, 1e-5, 0.01)
    want = F.leaky_relu(F.instance_norm(x.float().permute(0, 4, 1, 2, 3), weight=gamma,
                                        bias=beta, eps=1e-5), 0.01).permute(0, 2, 3, 4, 1)
    assert got.dtype == torch.bfloat16
    # the same values to f32's rounding, then one bf16 rounding: at most one
    # bf16 step apart where the f32 values straddle a rounding boundary
    step = want.abs().clamp_min(1e-3) * 2.0 ** -8
    assert bool(((got.float() - want).abs() <= step).all())
    assert float((got.float() - want.to(torch.bfloat16).float()).abs().max()) <= float(step.max())
    assert torch.equal(IN.instance_norm_lrelu(x, gamma, beta), got)


def test_padding_rule_on_a_window_not_divisible_by_the_strides(tiny):
    """21 x 12 x 14 is not a multiple of the divisor 4 on x and z: the engine
    pads the z-scored window with zeros on the high side to 24 x 12 x 16 and
    crops the logits back. Raw voxels of the intensity mean z-score to 0, so
    padding the raw with them is the same input."""
    model, params, ref = tiny
    assert model.divisor == (4, 4, 4) and model.padded_shape((21, 12, 14)) == (24, 12, 16)
    x = _raw((21, 12, 14), 5)
    lg = _engine_logits(model, params, x)
    assert lg.shape == (4, 21, 12, 14)
    padded = torch.full((24, 12, 16), 128, dtype=torch.uint8)
    padded[:21, :, :14] = x
    assert torch.equal(lg, _engine_logits(model, params, padded)[:, :21, :, :14])
    mean, mx, lsb_mean, lsb_max = _gaps(lg, ref(x))
    assert mean < LOGIT_MEAN and mx < LOGIT_MAX and lsb_mean < LSB_MEAN and lsb_max <= LSB_MAX


def _reference_tiles(ref, vol, tile, halo):
    """Each tile's reference probabilities from its zero-padded window, the
    halo cropped, assembled to (C, X, Y, Z) uint8."""
    sh = np.array(vol.shape)
    out = torch.zeros((4,) + tuple(vol.shape), dtype=torch.uint8)
    grid = -(-sh // np.array(tile))
    pad = torch.zeros(tuple(int(g * t + 2 * h) for g, t, h in zip(grid, tile, halo)),
                      dtype=torch.uint8)
    pad[halo[0]:halo[0] + sh[0], halo[1]:halo[1] + sh[1], halo[2]:halo[2] + sh[2]] = vol
    for gx in range(grid[0]):
        for gy in range(grid[1]):
            for gz in range(grid[2]):
                o = np.array([gx, gy, gz]) * tile
                w = pad[o[0]:o[0] + tile[0] + 2 * halo[0], o[1]:o[1] + tile[1] + 2 * halo[1],
                        o[2]:o[2] + tile[2] + 2 * halo[2]]
                p = _probs_u8(ref(w))[:, halo[0]:halo[0] + tile[0], halo[1]:halo[1] + tile[1],
                                      halo[2]:halo[2] + tile[2]]
                e = np.minimum(o + tile, sh) - o
                out[:, o[0]:o[0] + e[0], o[1]:o[1] + e[1], o[2]:o[2] + e[2]] = \
                    p[:, :e[0], :e[1], :e[2]]
    return out


def test_model_through_both_dense_predictors(tiny):
    """Four classes a voxel (n_classes x patch voxels = 4) through the tiled
    predictor (a tile a forward) and the resident one (four), on the CPU,
    against the reference's tiling. (The two differ by the CPU's rounding of
    a batch of 1 and of 4 in the plain convs.)"""
    model, params, ref = tiny
    vol = _raw((20, 12, 10), 6)
    tile, halo = (8, 8, 4), (4, 2, 2)    # windows 16 x 12 x 8
    want = _reference_tiles(ref, vol, np.array(tile), np.array(halo))
    tiled = DenseTilePredictor(model, params, tile_shape=tile, halo=halo, device="cpu")
    got = torch.from_numpy(tiled.predict_array(vol.numpy())).permute(3, 0, 1, 2)
    res = ResidentDensePredictor(model, params, tile_shape=tile, halo=halo, device="cpu")
    packed, grid = res.predict_volume_packed(vol)
    assert packed.shape[-1] == 4 and res.n_forward == 5   # 18 tiles, 4 a forward
    resident = torch.stack([res.class_volume_device(packed, grid, ch, tuple(vol.shape))
                            for ch in range(4)])
    for out in (got, resident):
        gap = (out.int() - want.int()).abs().float()
        assert float(gap.mean()) < LSB_MEAN and float(gap.max()) <= LSB_MAX
    # the stream route's mag-2 maps pooled where the tiles are: the floor of
    # each 2x2x2 block's mean, a ragged crop edge-padded
    win = np.zeros((2, 16, 12, 8), np.uint8)
    win[0] = vol.numpy()[:16, :12, :8]
    out, pooled = tiled.dispatch(win, np.array([[8, 8, 4], [7, 5, 3]]), [1, 3])
    assert pooled.shape == (2, 2, 4, 4, 2)
    maps = torch.from_numpy(out[1]).permute(3, 0, 1, 2)[[1, 3], :7, :5, :3].int()
    maps = F.pad(maps[None].float(), (0, 1, 0, 1, 0, 1), mode="replicate")[0].int()
    want2 = maps.reshape(2, 4, 2, 3, 2, 2, 2).sum((2, 4, 6)) >> 3
    assert torch.equal(torch.from_numpy(pooled[1, :, :4, :3, :2]).int(), want2)
    with pytest.raises(ValueError, match="of 8"):
        DenseTilePredictor(model, params, tile_shape=tile, halo=halo, mode="masks", device="cpu")


def test_unet_goes_through_the_seam_unchanged():
    """The U-Net's engine is the one the predictor called before the seam:
    the flax tree converted by ``params_from_flax``, run by
    ``unet_apply_packed``; anything else is refused."""
    from syconn_tpu_torch.models import unet_engine
    from syconn_tpu_torch.models.convert import params_from_flax
    from syconn_tpu_torch.models.io import init_model_params
    from syconn_tpu_torch.models.unet3d import UNet3D

    model = UNet3D(features=(8, 16), strides=((2, 2, 2),), patch=(2, 2, 2), n_classes=4)
    assert engine_of(model) == (params_from_flax, unet_engine.unet_apply_packed)
    assert engine_of(NNUNet(**TINY)) == (E.device_params, E.nnunet_apply_packed)
    with pytest.raises(TypeError, match="UNet3D and NNUNet"):
        engine_of(object())
    params = init_model_params(model, seed=2)
    pred = DenseTilePredictor(model, params, tile_shape=(8, 8, 4), halo=(4, 4, 2), device="cpu")
    x = torch.from_numpy(np.asarray(_raw((1, 16, 16, 8), 7)))
    lg = unet_engine.unet_apply_packed(model, params_from_flax(params, torch.device("cpu")),
                                       x[..., None])
    want = dense.dense_head(lg, (2, 2, 1), (4, 4, 2), 4, 8, "probs")
    assert torch.equal(pred._forward(x), want)
