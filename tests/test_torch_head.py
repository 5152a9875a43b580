"""The dense step's head (``ops/head.py``) on the CPU: the plain path equals
the head that ``DenseTilePredictor._forward_on`` computed inline before it
became an op (crop from the predictor's tile, halo and patch, softmax over
the classes, quantise or threshold and bit-pack), ``_forward_on`` takes the
plain path on the CPU and launches nothing, the kernel's block plan, and the
arguments the op refuses. The kernel itself is held to the plain path on the
card (``tests/test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch
from _torch_helpers import head_logits

from syconn_tpu_torch.inference.dense import DenseTilePredictor
from syconn_tpu_torch.models.io import init_model_params
from syconn_tpu_torch.models.unet3d import UNet3D
from syconn_tpu_torch.ops import conv3d as C
from syconn_tpu_torch.ops import head as H

BITS = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _inline_head(lg, tile_shape, halo, patch, n_classes, mode, thr, bit_weights):
    """The head as ``_forward_on`` wrote it inline, crop arithmetic included."""
    tsp = np.asarray(tile_shape, np.int64) // np.asarray(patch, np.int64)
    hp = np.asarray(halo, np.int64) // np.asarray(patch, np.int64)
    pvox = int(np.prod(patch))
    lg = lg[:, hp[0]:hp[0] + tsp[0], hp[1]:hp[1] + tsp[1], hp[2]:hp[2] + tsp[2], :]
    b, sx, sy, sz, _ = lg.shape
    probs = torch.softmax(lg.reshape(b, sx, sy, sz, n_classes, pvox), dim=-2)
    if mode == "probs":
        out = torch.round(probs * 255.0).to(torch.uint8)
        return out.reshape(b, sx, sy, sz, n_classes * pvox)
    fg = (probs >= thr).reshape(b, sx, sy, sz, n_classes * pvox // 8, 8)
    return (fg.to(torch.uint8) * bit_weights).sum(-1, dtype=torch.uint8)


# (n_classes, tile, halo, patch): organelles, syntype and myelin at small
# tiles with a halo on every side and unequal extents
SHAPES = {
    "organelles": (4, (24, 16, 12), (4, 6, 2), (2, 2, 2)),
    "syntype": (3, (16, 24, 8), (8, 4, 2), (4, 4, 2)),
    "myelin": (2, (8, 16, 12), (4, 4, 4), (4, 4, 2)),
    "patch1": (8, (6, 5, 7), (1, 2, 3), (1, 1, 1)),
}


def test_plain_head_equals_the_inline_head():
    for name, (n_classes, tile, halo, patch) in SHAPES.items():
        thr = torch.tensor(np.linspace(0.3, 0.7, n_classes, dtype=np.float32)[:, None])
        tsp = np.asarray(tile) // np.asarray(patch)
        hp = np.asarray(halo) // np.asarray(patch)
        for kind in ("normal", "large", "equal", "half"):
            lg = head_logits(2, tile, halo, patch, n_classes, seed=len(name), kind=kind)
            for mode in ("probs", "masks"):
                args = (mode, thr, BITS)
                got = H.dense_head(lg, hp, tsp, n_classes, int(np.prod(patch)), *args)
                ref = _inline_head(lg, tile, halo, patch, n_classes, *args)
                assert got.dtype == torch.uint8 and got.is_contiguous()
                assert torch.equal(got, ref), (name, kind, mode)


def test_forward_on_takes_the_plain_head_on_the_cpu(monkeypatch):
    model = UNet3D(features=(8, 16), strides=((2, 2, 2),), patch=(2, 2, 2), n_classes=4)
    params = init_model_params(model, 0)
    calls = []
    real = H.dense_head_ref
    monkeypatch.setattr(H, "dense_head_ref", lambda *a: calls.append(a[0].shape) or real(*a))

    def no_kernel(name):
        raise AssertionError(f"the CPU path asked for the {name} kernel")

    monkeypatch.setattr("syconn_tpu_torch.ops.build.library", no_kernel)
    vol = np.random.default_rng(3).integers(0, 256, (2, 48, 40, 24), dtype=np.uint8)
    for mode in ("probs", "masks"):
        C.reset_launch_counts()
        pred = DenseTilePredictor(model, params, tile_shape=(32, 24, 16), halo=(8, 8, 4),
                                  batch_size=2, mode=mode, device="cpu")
        out = pred.dispatch(vol)
        assert C.LAUNCHES["dense_head"] == 0
        width = 32 if mode == "probs" else 4
        assert out.shape == (2, 16, 12, 8, width)
    assert calls == [(2, 24, 20, 12, 32)] * 2


def test_head_plan():
    # organelles: 40 floats a position (8 mod 32), the whole 64-position run a block
    assert H.head_plan(4, 8, 64) == dict(P=64, S=40)
    # syntype and myelin: no padding, the whole run
    assert H.head_plan(3, 32, 64) == dict(P=64, S=96)
    assert H.head_plan(2, 32, 64) == dict(P=64, S=64)
    # a long run is cut into pieces
    assert H.head_plan(3, 32, 200)["P"] == 85
    assert H.head_plan(1024, 16, 8) is None
    for n_classes in (1, 2, 3, 4, 5, 8):
        for pvox in (4, 8, 16, 32):
            if n_classes * pvox % 8:
                continue
            plan = H.head_plan(n_classes, pvox, 128)
            s = plan["S"]
            assert s >= n_classes * pvox and s % 4 == 0
            assert plan["P"] * s * 4 <= H.MAX_PIECE_BYTES
            # one warp's 32 (position, voxel) pairs read 32 distinct banks, every class
            for c in range(n_classes):
                banks = {(j // pvox * s + c * pvox + j % pvox) % 32 for j in range(32)}
                assert len(banks) == 32, (n_classes, pvox, c)


def test_head_rejects_what_it_does_not_take():
    lg = torch.zeros((1, 6, 6, 6, 32))
    with pytest.raises(ValueError, match="mode"):
        H.dense_head(lg, (1, 1, 1), (4, 4, 4), 4, 8, "logits")
    with pytest.raises(ValueError, match="outside"):
        H.dense_head(lg, (1, 1, 3), (4, 4, 4), 4, 8)
    with pytest.raises(ValueError, match="expected logits"):
        H.dense_head(lg, (1, 1, 1), (4, 4, 4), 3, 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        H.dense_head(torch.zeros((1, 6, 6, 6, 6)), (1, 1, 1), (4, 4, 4), 3, 2)
    with pytest.raises(ValueError, match="of 8"):
        H.dense_head(torch.zeros((1, 6, 6, 6, 12)), (1, 1, 1), (4, 4, 4), 3, 4, "masks",
                     torch.full((3, 1), 0.5), torch.tensor([1, 2, 4, 8, 16, 32, 64, 128],
                                                           dtype=torch.uint8))
    with pytest.raises(ValueError, match="thr"):
        H.dense_head(lg, (1, 1, 1), (4, 4, 4), 4, 8, "masks")
