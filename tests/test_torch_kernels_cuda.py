"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerance as in tests/test_torch_conv3d.py: median relative error < 2e-2
and fewer than 2% of elements off by more than 10% (same exact bf16
products, f32 sums in another order, bf16 rounding).
"""

import numpy as np
import pytest
import torch

from syconn_tpu_torch.ops import conv3d as C

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from syconn_tpu_torch.utils.device import default_device

    return default_device()


def _close(got, ref, floor=1e-2):
    got, ref = got.float().cpu(), ref.float().cpu()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    rel = (got - ref).abs() / ref.abs().clamp_min(floor)
    assert float(rel.median()) < 2e-2
    assert float((rel > 0.1).float().mean()) < 2e-2


@pytest.mark.parametrize("case", ["same", "head", "bias", "down", "up", "odd"])
def test_kernel_matches_plain_version(dev, case):
    g = torch.Generator().manual_seed(6)
    cin, cout = (64, 128) if case in ("down", "up") else (32, 64)
    shape = (1, 13, 7, 21, 40) if case == "odd" else (1, 12, 8, 20, cin)
    cin = shape[-1]
    nh = 96 if case == "head" else 0
    x = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn((27, cin, cout), generator=g) / (27 * cin) ** 0.5).to(dev, torch.bfloat16)
    b = (0.1 * torch.randn((cout,), generator=g)).to(dev, torch.bfloat16)
    ln = [(1 + 0.1 * torch.randn((cout,), generator=g)).to(dev),
          (0.1 * torch.randn((cout,), generator=g)).to(dev)]
    head = {}
    if nh:
        head = dict(head_w=(torch.randn((cout, nh), generator=g) / cout ** 0.5).to(dev),
                    head_b=(0.1 * torch.randn((nh,), generator=g)).to(dev))
    C.reset_launch_counts()
    if case == "down":
        got, ref = C.conv_down2x_bias(x, w, b), C.conv_down2x_bias_ref(x, w, b)
    elif case == "up":
        got, ref = C.conv_transpose2x_bias(x, w, b), C.conv_transpose2x_bias_ref(x, w, b)
    else:
        epi = "bias" if case == "bias" else "ln_gelu"
        got = C.conv3x3x3_ln_gelu(x, w, b, *ln, epilogue=epi, **head)
        ref = C.conv3x3x3_ln_gelu_ref(x, w, b, *ln, epilogue=epi, **head)
    torch.cuda.synchronize()
    assert sum(C.LAUNCHES.values()) == 1
    _close(got, ref)


def test_kernel_rejects_what_it_does_not_take(dev):
    x = torch.zeros((1, 4, 4, 4, 12), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((27, 12, 64), dtype=torch.bfloat16, device=dev)
    b = torch.zeros((64,), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="Cin"):
        C.conv3x3x3_ln_gelu(x, w, b, epilogue="bias")
    with pytest.raises(TypeError):
        C.conv_down2x_bias(x.float()[..., :8].contiguous(), w[:, :8].contiguous(), b)


def test_predictor_kernel_path_matches_cpu_path(dev):
    """The dense predictor on the kernels vs on the plain CPU versions, with
    the packaged syntype weights: uint8 probabilities within 2 LSB on
    >= 99.9% of voxels, and every kernel of the path launched."""
    from syconn_tpu_torch.inference.dense import DenseTilePredictor
    from syconn_tpu_torch.models.io import load_model, packaged_model_path

    model, params = load_model(packaged_model_path("syntype"))
    vol = np.random.default_rng(1).integers(0, 256, (64, 64, 32), dtype=np.uint8)
    kw = dict(tile_shape=(64, 64, 32), halo=(8, 8, 4), mode="probs")
    C.reset_launch_counts()
    got = DenseTilePredictor(model, params, device=dev, **kw).predict_array(vol)
    assert C.LAUNCHES == {"conv3x3x3_ln_gelu": 10, "conv_down2x_bias": 2,
                          "conv_transpose2x_bias": 2}
    ref = DenseTilePredictor(model, params, device="cpu", **kw).predict_array(vol)
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert np.mean(d <= 2) >= 0.999
