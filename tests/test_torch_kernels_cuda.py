"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerance of the convs as in tests/test_torch_conv3d.py: median relative
error < 2e-2 and fewer than 2% of elements off by more than 10% (same exact
bf16 products, f32 sums in another order, bf16 rounding). The contact kernel
computes integers: equal to its plain version, tolerance 0.
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


# case -> (kernel, x shape (B, X, Y, Z, Cin), Cout, head width, epilogue)
CASES = {
    "same": ("same", (1, 12, 8, 20, 32), 64, 0, "ln_gelu"),
    "head": ("same", (1, 12, 8, 20, 32), 64, 96, "ln_gelu"),
    "head64": ("same", (1, 9, 17, 8, 64), 64, 64, "ln_gelu"),
    "head_odd_width": ("same", (1, 8, 8, 8, 32), 32, 5, "ln_gelu"),
    "head_mma_sync": ("same", (1, 6, 9, 8, 32), 256, 96, "ln_gelu"),  # too wide for the wgmma kernel
    "bias": ("same", (1, 12, 8, 20, 32), 64, 0, "bias"),
    "down": ("down", (1, 12, 8, 20, 64), 128, 0, "bias"),
    "down_ragged": ("down", (1, 22, 14, 10, 64), 128, 0, "bias"),     # even, ragged on 8 x 8
    "down_batch2": ("down", (2, 16, 12, 20, 32), 64, 0, "bias"),
    "down_cout32": ("down", (1, 20, 18, 16, 64), 32, 0, "bias"),
    "down_cout256_cin40": ("down", (1, 22, 14, 10, 40), 256, 0, "bias"),  # Cin % 32 != 0
    "down_deep": ("down", (1, 16, 16, 16, 256), 256, 0, "bias"),      # the ring wraps many times
    "up": ("up", (1, 12, 8, 20, 64), 128, 0, "bias"),
    "odd": ("same", (1, 13, 7, 21, 40), 64, 0, "ln_gelu"),
    "cout32": ("same", (1, 10, 16, 16, 64), 32, 0, "ln_gelu"),
    "cout128": ("same", (1, 10, 16, 16, 128), 128, 0, "ln_gelu"),
    "cout256": ("same", (1, 5, 11, 16, 96), 256, 0, "ln_gelu"),
    "ragged": ("same", (1, 21, 13, 7, 64), 64, 0, "ln_gelu"),
    "batch2": ("same", (2, 9, 10, 12, 64), 64, 0, "ln_gelu"),
    "cin8": ("same", (1, 8, 9, 10, 8), 64, 0, "ln_gelu"),
    "deep": ("same", (1, 8, 8, 16, 256), 128, 0, "ln_gelu"),  # the ring wraps many times
    "up_odd": ("up", (1, 5, 7, 9, 128), 64, 0, "bias"),
    "up_batch2": ("up", (2, 4, 9, 8, 40), 32, 0, "bias"),
    "up_cout256": ("up", (1, 3, 8, 10, 64), 256, 0, "bias"),
    "up_resident": ("up", (1, 9, 12, 20, 256), 128, 0, "bias"),   # all slices stay in shared memory
    "up_streams": ("up", (1, 4, 8, 9, 544), 64, 0, "bias"),       # too many slices to keep
    "many_bricks": ("same", (1, 80, 48, 40, 64), 64, 0, "ln_gelu"),   # several bricks per block
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_version(dev, case):
    kernel, shape, cout, nh, epi = CASES[case]
    g = torch.Generator().manual_seed(6)
    cin = shape[-1]
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
    if kernel == "down":
        got, ref = C.conv_down2x_bias(x, w, b), C.conv_down2x_bias_ref(x, w, b)
    elif kernel == "up":
        got, ref = C.conv_transpose2x_bias(x, w, b), C.conv_transpose2x_bias_ref(x, w, b)
    else:
        got = C.conv3x3x3_ln_gelu(x, w, b, *ln, epilogue=epi, **head)
        ref = C.conv3x3x3_ln_gelu_ref(x, w, b, *ln, epilogue=epi, **head)
    torch.cuda.synchronize()
    assert sum(C.LAUNCHES.values()) == 1
    # the Python mirror of the tile plan agrees with the launcher's
    from syconn_tpu_torch.ops.build import library

    plan = C.tile_plan(kernel, cin, cout, nh)
    mode = {"same": 0, "down": 1, "up": 2}[kernel]
    assert (plan is not None) == (case != "head_mma_sync")
    assert library("conv3d_wgmma").conv3d_wgmma_plan(mode, cin, cout, nh) == (
        plan["smem_bytes"] if plan else 0)
    _close(got, ref)


def test_repacked_weights_follow_the_parameter(dev):
    """The packed image is cached per tensor and rebuilt after an in-place write."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((1, 8, 8, 8, 32), generator=g).to(dev, torch.bfloat16)
    w = (torch.randn((27, 32, 64), generator=g) / 30).to(dev, torch.bfloat16)
    b = torch.zeros((64,), dtype=torch.bfloat16, device=dev)
    first = C.conv3x3x3_ln_gelu(x, w, b, epilogue="bias")
    assert torch.equal(first, C.conv3x3x3_ln_gelu(x, w, b, epilogue="bias"))
    w.mul_(2)
    _close(C.conv3x3x3_ln_gelu(x, w, b, epilogue="bias"),
           C.conv3x3x3_ln_gelu_ref(x, w, b, epilogue="bias"))


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
                          "conv_transpose2x_bias": 2, "detect_cs_columns": 0, "dense_head": 1}
    ref = DenseTilePredictor(model, params, device="cpu", **kw).predict_array(vol)
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert np.mean(d <= 2) >= 0.999


def test_head_span_counts_the_kernels_tiles(dev):
    """The ``engine.head`` span's ``fused_tiles`` is the batch the head
    kernel took."""
    from syconn_tpu_torch.inference.dense import DenseTilePredictor
    from syconn_tpu_torch.models.io import load_model, packaged_model_path
    from syconn_tpu_torch.utils import tracing

    model, params = load_model(packaged_model_path("syntype"))
    pred = DenseTilePredictor(model, params, tile_shape=(64, 64, 32), halo=(8, 8, 4),
                              batch_size=2, mode="probs", device=dev)
    x = torch.randint(0, 256, pred._in_shape, dtype=torch.uint8, device=dev)
    tracing.clear()
    C.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pred._forward(x)
        torch.cuda.synchronize()
    heads = [r for r in tracing.records() if r["name"] == "engine.head"]
    tracing.clear()
    assert C.LAUNCHES["dense_head"] == 1
    assert [r["attrs"]["fused_tiles"] for r in heads] == [2]


# (n_classes, tile, halo, patch): both configurations' patches with a halo on
# every side and unequal extents; myelin's (2, 32) and patch 1 take the
# kernel's generic loop; the long run is cut into two pieces (85 + 15
# positions), whose masks bytes are not 16-byte aligned
HEAD_CASES = {
    "organelles": (4, (64, 48, 40), (8, 4, 6), (2, 2, 2)),
    "syntype": (3, (48, 64, 24), (4, 8, 2), (4, 4, 2)),
    "syntype_long_run": (3, (8, 12, 200), (4, 4, 4), (4, 4, 2)),
    "myelin": (2, (32, 48, 16), (8, 4, 4), (4, 4, 2)),
    "patch1": (8, (12, 10, 14), (1, 2, 3), (1, 1, 1)),
}


def _head_args(dev, name, batch, kind):
    from _torch_helpers import head_logits

    n_classes, tile, halo, patch = HEAD_CASES[name]
    lg = head_logits(batch, tile, halo, patch, n_classes, seed=sum(map(ord, name)), kind=kind)
    thr = torch.tensor(np.linspace(0.3, 0.7, n_classes, dtype=np.float32)[:, None])
    bits = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8)
    hp = np.asarray(halo) // np.asarray(patch)
    tsp = np.asarray(tile) // np.asarray(patch)
    return lg.to(dev), hp, tsp, n_classes, int(np.prod(patch)), thr.to(dev), bits.to(dev)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("kind", ["normal", "large", "equal", "half"])
@pytest.mark.parametrize("mode", ["probs", "masks"])
@pytest.mark.parametrize("name", list(HEAD_CASES))
def test_head_kernel_matches_plain_version(dev, name, mode, kind, batch):
    """The head kernel against its plain version on the card: probabilities
    byte for byte, masks bit for bit, per-class thresholds, logits up to
    +-80, equal across the classes, or putting p * 255 on a half."""
    from syconn_tpu_torch.ops import head as H

    lg, hp, tsp, n_classes, pvox, thr, bits = _head_args(dev, name, batch, kind)
    C.reset_launch_counts()
    got = H.dense_head(lg, hp, tsp, n_classes, pvox, mode, thr, bits)
    ref = H.dense_head_ref(lg, hp, tsp, n_classes, pvox, mode, thr, bits)
    torch.cuda.synchronize()
    assert C.LAUNCHES["dense_head"] == 1
    assert got.is_cuda and got.dtype == torch.uint8 and got.is_contiguous()
    assert got.shape == ref.shape
    d = (got.int() - ref.int()).abs()
    off = int((d > 0).sum())
    assert off == 0, f"{off} of {d.numel()} bytes off the plain head, at most {int(d.max())}"


def test_head_kernel_rejects_what_it_does_not_take(dev):
    from syconn_tpu_torch.ops import head as H

    lg, hp, tsp, n_classes, pvox, thr, bits = _head_args(dev, "organelles", 1, "normal")
    with pytest.raises(ValueError, match="f32"):
        H.dense_head(lg.half(), hp, tsp, n_classes, pvox)
    with pytest.raises(ValueError, match="f32"):
        H.dense_head(lg[:, :, :, 1:], hp, tsp, n_classes, pvox)  # not contiguous
    with pytest.raises(ValueError, match="thr"):
        H.dense_head(lg, hp, tsp, n_classes, pvox, "masks", thr[:2], bits)


@pytest.mark.parametrize("tile,patch,extents", [
    ((256, 256, 128), (2, 2, 2), [(256, 256, 128), (255, 13, 127), (0, 0, 0)]),  # padding row
    ((256, 256, 128), (4, 4, 2), [(37, 256, 128), (256, 255, 1), (0, 0, 0)]),
    ((64, 64, 32), (2, 2, 2), [(63, 64, 31)]),
])
def test_pool_kernel_matches_plain_version_and_the_chunk_store(dev, tmp_path, tile, patch,
                                                                extents):
    """``ops.pool.pool_mag2`` on the card equals the same call on the CPU
    byte for byte and, inside a crop, the chunk store's host pooling
    (float32 mean of the edge-padded tile, truncated)."""
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.ops.pool import pool_mag2

    sp = [t // p for t, p in zip(tile, patch)]
    rng = np.random.default_rng(11)
    packed = rng.integers(0, 256, (len(extents), *sp, 4 * int(np.prod(patch))), dtype=np.uint8)
    classes = [1, 2, 3]
    got = pool_mag2(torch.from_numpy(packed).to(dev), extents, patch, 4, classes)
    assert got.is_cuda
    ref = pool_mag2(torch.from_numpy(packed), extents, patch, 4, classes)
    assert torch.equal(got.cpu(), ref)
    vox = packed.reshape(len(extents), *sp, 4, *patch).transpose(0, 4, 1, 5, 2, 6, 3, 7)
    vox = vox.reshape(len(extents), 4, *tile)
    row = 1 if len(extents) > 1 else 0
    e = extents[row]
    h = [-(-x // 2) for x in e]
    store = ChunkedVolume.create(str(tmp_path / "s"), scale=(1, 1, 1), boundary=tile,
                                 chunk_shape=tile)
    store.save_raw(vox[row, 2, :e[0], :e[1], :e[2]].copy(), (0, 0, 0), mags=(2,))
    assert np.array_equal(got[row, 1, :h[0], :h[1], :h[2]].cpu().numpy(),
                          store.load_raw(size=h, mag=2))


@pytest.mark.parametrize("task", ["syntype", "organelles"])
def test_dense_step_pools_mag2_on_the_card(dev, tmp_path, task):
    """``predict_dense_to_kd`` on the card pools the maps to mag 2 on the
    card: its files at mag 2 equal the chunk store's host pooling of its own
    mag-1 tiles (as the CPU path writes them), whatever the model. Its mag-1 maps lie within 2 LSB of the
    CPU path's (bf16 kernels against the plain versions) on as many voxels
    as the packaged weights' card tests ask: >= 99.9% for syntype (patch
    (4, 4, 2), as ``test_predictor_kernel_path_matches_cpu_path``), the
    organelles budget ``chip_smoke.ORG_BUDGET`` for organelles (patch
    (2, 2, 2), as ``test_organelles_layers_card_match_cpu``). The host
    pooling is the port's chunk store: this file imports no JAX."""
    from syconn_tpu_torch.inference.dense import predict_dense_to_kd
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.models.io import load_model, packaged_model_path

    model, params = load_model(packaged_model_path(task))
    chans = {"asym": 1, "sym": 2} if task == "syntype" else {"mi": 1, "vc": 2, "sj": 3}
    within = 0.999 if task == "syntype" else _smoke().ORG_BUDGET["within_2_lsb"]
    shape, tile = (127, 96, 40), np.array((64, 64, 32))
    vol = np.random.default_rng(12).integers(0, 256, shape, dtype=np.uint8)
    src = str(tmp_path / "raw")
    ChunkedVolume.create(src, scale=(10, 10, 20), boundary=shape,
                         chunk_shape=(64, 64, 32)).save_raw(vol)
    outs = {}
    for d in (dev, "cpu"):
        targets = {n: str(tmp_path / f"{n}_{torch.device(d).type}") for n in chans}
        predict_dense_to_kd(src, targets, model, params, chans, tile_shape=tuple(tile),
                            halo=(8, 8, 4), batch_size=3, show_progress=False, device=d)
        outs[torch.device(d).type] = targets
    offsets = [np.array([x, y, z]) for x in range(0, shape[0], 64) for y in range(0, shape[1], 64)
               for z in range(0, shape[2], 32)]
    for n in chans:
        card = ChunkedVolume.open(outs["cuda"][n])
        m1 = card.load_raw(mag=1)
        cpu = ChunkedVolume.open(outs["cpu"][n]).load_raw(mag=1)
        d = np.abs(m1.astype(np.int16) - cpu.astype(np.int16))
        assert np.mean(d <= 2) >= within, (n, float(np.mean(d <= 2)))
        ref = ChunkedVolume.create(str(tmp_path / f"{n}_ref"), scale=card.scale,
                                   boundary=card.boundary, chunk_shape=card.chunk_shape,
                                   codec=card.codec)
        for o in offsets:
            hi = np.minimum(o + tile, shape)
            ref.save_raw(m1[o[0]:hi[0], o[1]:hi[1], o[2]:hi[2]].copy(), o, mags=(1, 2))
        assert np.array_equal(ref.load_raw(mag=2), card.load_raw(mag=2))


def test_organelles_layers_card_match_cpu(dev):
    """The organelles U-Net layer by layer on the card against the plain CPU
    path (``tools/engine_layers.py``): each layer alone, fed the CPU's
    input, within the conv tolerance; softmax and rounding of the same
    logits within 1 LSB; end to end on chip_smoke's reference input within
    the budget that phase holds (``chip_smoke.ORG_BUDGET``)."""
    from syconn_tpu_torch.inference.dense import DenseTilePredictor
    from syconn_tpu_torch.models.convert import params_from_flax
    from syconn_tpu_torch.models.io import load_model, packaged_model_path
    from syconn_tpu_torch.tools.engine_layers import layer_report

    budget = _smoke().ORG_BUDGET
    model, params = load_model(packaged_model_path("organelles"))
    vol = np.random.default_rng(1).integers(0, 256, (64, 64, 32), dtype=np.uint8)
    rows = layer_report(model, params_from_flax(params, dev), params_from_flax(params, "cpu"),
                        vol[:32, :32, :16], dev)
    for row in rows[:-1]:
        assert row["alone"]["median_rel"] < 2e-2 and row["alone"]["share_rel_gt_0.1"] < 2e-2, row
    assert rows[-1]["max_lsb"] <= 1
    kw = dict(tile_shape=(64, 64, 32), halo=(16, 16, 8), mode="probs")
    got = DenseTilePredictor(model, params, device=dev, **kw).predict_array(vol)
    ref = DenseTilePredictor(model, params, device="cpu", **kw).predict_array(vol)
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert np.mean(d <= 2) >= budget["within_2_lsb"]
    assert np.mean(got.argmax(-1) == ref.argmax(-1)) >= budget["argmax_stable"]


def _smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _blocky(seed, n_labels, grid, block):
    rng = np.random.default_rng(seed)
    return np.kron(rng.integers(0, n_labels, size=grid).astype(np.uint32),
                   np.ones(block, np.uint32))


def _dense_labels():
    """The dense-label contact shape of chip_smoke.py, cut to 3 x 3 columns:
    blocks of (24, 24, 40) voxels, ~22 live candidates a column of K = 32."""
    return _smoke().blocky_labels((108, 108, 134), (24, 24, 40), seed=11).astype(np.uint32)


@pytest.mark.parametrize("case", ["tile16", "tile32_ragged", "overflow_k8", "dense_k32"])
def test_contact_kernel_matches_plain_version(dev, case):
    """``detect_cs_columns`` on the card == its plain version on the same
    CUDA tensors, and the whole column path == the exact host kernel."""
    from syconn_tpu_torch.ops import contacts_cuda as CC
    from syconn_tpu_torch.ops.contacts import detect_cs
    from syconn_tpu_torch.ops.contacts_torch import column_tables

    seg, stencil, tile_xy, K = {
        "tile16": (_blocky(3, 5, (10, 10, 6), (6, 6, 6)), (13, 13, 7), (16, 16), 16),
        "tile32_ragged": (_blocky(8, 7, (9, 7, 5), (8, 9, 7))[:70, :59, :33], (5, 5, 3),
                          (32, 32), 16),
        "overflow_k8": (_blocky(4, 24, (12, 12, 6), (4, 4, 6)), (13, 13, 7), (16, 16), 8),
        "dense_k32": (_dense_labels(), (13, 13, 7), (32, 32), 32),
    }[case]
    seg_p, offs, cands, overflow = column_tables(torch.from_numpy(seg.astype(np.int32)).to(dev),
                                                 stencil, tile_xy, K)
    assert bool(overflow.any()) == (case == "overflow_k8") or case == "dense_k32"
    if case == "dense_k32":
        assert 16 <= float((cands != 2**31 - 1).sum(dim=1).float().mean()) <= 28
    args = [seg_p, offs, cands]
    C.reset_launch_counts()
    lo, hi = CC.detect_cs_columns(*args, stencil, tile_xy)
    torch.cuda.synchronize()
    assert C.LAUNCHES["detect_cs_columns"] == 1 and sum(C.LAUNCHES.values()) == 1
    lo_p, hi_p = CC.detect_cs_columns_ref(*args, stencil, tile_xy)
    assert bool(lo.any()) and torch.equal(lo, lo_p) and torch.equal(hi, hi_p)
    host = detect_cs(seg, stencil=stencil)
    assert np.array_equal(host, CC.detect_cs_cuda(seg, stencil, tile_xy, K, device=dev))


def test_contact_kernel_rejects_what_it_does_not_take(dev):
    from syconn_tpu_torch.ops import contacts_cuda as CC

    seg = torch.zeros((80, 80, 8), dtype=torch.int32, device=dev)
    offs = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    cands = torch.full((1, 4), 2**31 - 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="tx\\*ty"):
        CC.detect_cs_columns(seg, offs, cands, (5, 5, 3), (64, 32))
    with pytest.raises(ValueError, match="sx\\*sy\\*sz"):
        CC.detect_cs_columns(seg, offs, cands, (17, 17, 9), (16, 16))
    with pytest.raises(ValueError, match="K <= 32"):
        CC.detect_cs_columns(seg, offs, torch.full((1, 40), 2**31 - 1, dtype=torch.int32,
                                                   device=dev), (5, 5, 3), (16, 16))
    with pytest.raises(ValueError, match="contiguous"):
        CC.detect_cs_columns(seg.permute(1, 0, 2), offs, cands, (5, 5, 3), (16, 16))
    with pytest.raises(ValueError, match="is on"):
        CC.detect_cs_columns(seg, offs.cpu(), cands, (5, 5, 3), (16, 16))


def test_contact_extraction_card_matches_cpu(dev, tmp_path):
    """Streaming and resident runs on the card (both through the CUDA
    kernel, once per chunk) == the CPU run."""
    from syconn_tpu_torch.exec.exec_syns import run_contact_extraction
    from syconn_tpu_torch.io import resident
    from syconn_tpu_torch.io.chunked import ChunkedVolume

    sh = (96, 64, 48)
    seg = np.zeros(sh, np.uint64)
    seg[4:46, 4:60, 4:44] = 7
    seg[48:92, 4:60, 4:44] = 9
    kd = str(tmp_path / "seg")
    ChunkedVolume.create(kd, scale=(10, 10, 20), boundary=sh, chunk_shape=(64, 64, 64)).save_seg(seg)
    kw = dict(chunk_size=(32, 64, 48), min_obj_vx={"cs": 1}, overwrite=True)
    vols = {}
    for tag, d in (("cpu", "cpu"), ("stream", dev), ("resident", dev)):
        C.reset_launch_counts()
        if tag == "resident":
            assert resident.put(kd, "seg", seg, device=dev)
        try:
            res = run_contact_extraction(kd, str(tmp_path / tag), device=d, **kw)
        finally:
            resident.clear()
        assert res["stats"]["path"] == ("resident" if tag == "resident" else "stream")
        assert C.LAUNCHES["detect_cs_columns"] == (0 if tag == "cpu" else 3)
        vols[tag] = ChunkedVolume.open(str(tmp_path / tag / "cs_seg")).load_seg(size=sh)
    assert vols["cpu"].any()
    assert np.array_equal(vols["cpu"], vols["stream"])
    assert np.array_equal(vols["cpu"], vols["resident"])


# ------------------------------------------------ step 2 on the card (exact)
def _blob_prob(shape=(70, 45, 37), seed=4):
    rng = np.random.default_rng(seed)
    prob = rng.integers(0, 100, shape).astype(np.uint8)
    for _ in range(12):
        c = rng.integers(4, np.array(shape) - 4)
        r = rng.integers(3, 9, 3)
        prob[tuple(slice(max(0, int(c[i] - r[i])), int(c[i] + r[i])) for i in range(3))] = 220
    return prob


def test_morphology_chain_card_matches_cpu(dev):
    from syconn_tpu_torch.ops.morphology import get_aniso_struct
    from syconn_tpu_torch.ops.morphology_torch import (morphology_chain_device,
                                                       segment_chunk_device)

    struct = get_aniso_struct((10, 10, 20))
    mask = np.random.default_rng(0).random((64, 56, 40)) < 0.4
    for ops in (["binary_opening", "binary_closing"] + ["binary_erosion"] * 4,
                ["binary_dilation"] * 3 + ["binary_erosion"] * 3):
        assert np.array_equal(morphology_chain_device(mask, ops, struct, device=dev),
                              morphology_chain_device(mask, ops, struct, device="cpu"))
    prob = _blob_prob()
    ops = ["binary_opening", "binary_closing", "binary_erosion"]
    got = segment_chunk_device(prob, 72.0, ops, struct, device=dev)
    ref = segment_chunk_device(prob, 72.0, ops, struct, device="cpu")
    assert got[2] == ref[2] and np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])


def test_connected_components_card_matches_cpu(dev):
    from syconn_tpu_torch.ops.cc_torch import (connected_components_device,
                                               connected_components_torch)

    rng = np.random.default_rng(1)
    for p in (0.05, 0.3, 0.6, 0.9):
        mask = rng.random((48, 40, 32)) < p
        got = connected_components_device(torch.from_numpy(mask).to(dev)).cpu()
        assert torch.equal(got, connected_components_device(torch.from_numpy(mask)))
        lab, n = connected_components_torch(mask, device=dev)
        lab_c, n_c = connected_components_torch(mask, device="cpu")
        assert n == n_c and np.array_equal(lab, lab_c)


def test_property_scans_card_match_cpu(dev):
    from syconn_tpu_torch.ops.props_torch import object_properties_device, pair_counts_device

    rng = np.random.default_rng(2)
    vol = rng.integers(0, 3000, (64, 48, 40)).astype(np.int32)
    for max_ids in (1024, 4096):  # overflow folding, then the whole table
        got = object_properties_device(torch.from_numpy(vol).to(dev), max_ids)
        ref = object_properties_device(torch.from_numpy(vol), max_ids)
        for g, r in zip(got, ref):
            assert torch.equal(g.cpu(), r)
    a = rng.integers(0, 40, (64, 48, 40)).astype(np.int32)
    b = rng.integers(0, 40, (64, 48, 40)).astype(np.int32)
    for max_pairs in (256, 2048):
        got = pair_counts_device(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
                                 max_pairs)
        ref = pair_counts_device(torch.from_numpy(a), torch.from_numpy(b), max_pairs)
        for g, r in zip(got, ref):
            assert torch.equal(g.cpu(), r)


def test_resident_classes_card_match_cpu(dev):
    from syconn_tpu_torch.ops.morphology import get_aniso_struct, morphology_halo
    from syconn_tpu_torch.ops.morphology_torch import ResidentSegmenter
    from syconn_tpu_torch.ops.props_torch import ResidentPropsScanner

    struct = get_aniso_struct((10, 10, 20))
    prob = _blob_prob()
    ops = ["binary_opening", "binary_closing"] + ["binary_erosion"] * 4
    halo = morphology_halo(ops, 0, 2)
    segs = [ResidentSegmenter(torch.from_numpy(prob).to(d), (32, 32, 16), halo, 109.3, ops,
                              struct) for d in (dev, "cpu")]
    for cix in [(0, 0, 0), (2, 1, 2)]:
        got, ref = (s.fetch(s.dispatch(cix)) for s in segs)
        assert got[2] == ref[2] == 4
        assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    vol = np.random.default_rng(3).integers(0, 50, (70, 48, 40)).astype(np.int32)
    dense = (np.arange(32 ** 3, dtype=np.int32).reshape(32, 32, 32) // 4) + 1
    vol[:32, :32, :32] = dense  # > 4096 ids: the growth path
    scans = [ResidentPropsScanner(torch.from_numpy(vol).to(d), chunk=(32, 32, 32))
             for d in (dev, "cpu")]
    for cix in [(0, 0, 0), (2, 1, 1)]:
        for g, r in zip(scans[0].props(cix), scans[1].props(cix)):
            assert np.array_equal(g, r)


def test_resident_dense_card_matches_cpu(dev):
    """ResidentDensePredictor on the kernels: with the packaged syntype
    weights against its CPU path, uint8 probabilities within 2 LSB on
    >= 99.9% of values (as the streaming predictor above); with the packaged
    organelles weights against the streaming predictor on the card, equal
    (the same kernels on the same windows, batch 4 against batch 1)."""
    from syconn_tpu_torch.inference.dense import DenseTilePredictor, ResidentDensePredictor
    from syconn_tpu_torch.models.io import load_model, packaged_model_path

    vol = np.random.default_rng(5).integers(0, 256, (128, 128, 64), dtype=np.uint8)
    model, params = load_model(packaged_model_path("syntype"))
    kw = dict(tile_shape=(64, 64, 32), halo=(8, 8, 4), mode="probs")
    C.reset_launch_counts()
    got_p, grid = ResidentDensePredictor(model, params, device=dev, tile_batch=4,
                                         **kw).predict_volume_packed(torch.from_numpy(vol).to(dev))
    assert grid == (2, 2, 2)
    assert C.LAUNCHES["conv3x3x3_ln_gelu"] == 2 * 10 and C.LAUNCHES["conv_down2x_bias"] == 4
    ref_p, _ = ResidentDensePredictor(model, params, device="cpu", tile_batch=4,
                                      **kw).predict_volume_packed(vol)
    d = (got_p.cpu().int() - ref_p.int()).abs()
    assert float((d <= 2).float().mean()) >= 0.999
    model, params = load_model(packaged_model_path("organelles"))
    kw = dict(tile_shape=(32, 32, 32), halo=(8, 8, 8), mode="probs")
    res = ResidentDensePredictor(model, params, device=dev, tile_batch=4, **kw)
    packed, grid = res.predict_volume_packed(vol)
    full = DenseTilePredictor(model, params, device=dev, **kw).predict_array(vol)
    for c in range(model.n_classes):
        assert np.array_equal(res.class_volume_device(packed, grid, c, vol.shape).cpu().numpy(),
                              full[..., c])


@pytest.mark.parametrize("name", ["celltype_pts", "compartment_pts", "glia_pts", "spiness",
                                  "tnet_pts"])
def test_point_net_card_matches_cpu(dev, name):
    """The packaged point nets at their own npoints on the card against the
    CPU: kNN indices equal (ties included), logits within the dense budget
    (median relative error < 3e-2, argmax flips < 3e-3)."""
    import json
    import os

    from syconn_tpu_torch.inference.points import extract_contexts
    from syconn_tpu_torch.models.io import load_model, packaged_model_path
    from syconn_tpu_torch.models.pointnet import knn_indices

    path = packaged_model_path(name)
    with open(os.path.join(path, "arch.json")) as f:
        arch = json.load(f)
    npoints, k = int(arch["meta"]["npoints"]), int(arch["kwargs"]["k"])
    n_global = int(arch["kwargs"].get("n_global", 0))
    rng = np.random.default_rng(0)
    coords = (rng.integers(0, 30, (1500, 3)) * np.array([10, 10, 20])).astype(np.float32)
    types = rng.integers(0, 4, len(coords)).astype(np.int32)
    ctx, _ = extract_contexts(coords, types, ctx_size_nm=2400, npoints=npoints, n_contexts=4,
                              rng=np.random.default_rng(1))
    if n_global:
        s = rng.normal(size=(4, 1, n_global)).astype(np.float32)
        ctx = np.concatenate([ctx, np.broadcast_to(s, (4, npoints, n_global))], -1)
    x = torch.from_numpy(np.ascontiguousarray(ctx))
    assert torch.equal(knn_indices(x[..., :3].to(dev), k).cpu(), knn_indices(x[..., :3], k))
    model, _ = load_model(path)
    with torch.inference_mode():
        ref = model(x)
        got = model.to(dev)(x.to(dev))
    ref = ref["logits"] if isinstance(ref, dict) else ref
    got = (got["logits"] if isinstance(got, dict) else got).cpu()
    rel = (got - ref).abs() / ref.abs().clamp_min(1e-2)
    assert bool(torch.isfinite(got).all()) and float(rel.median()) < 3e-2
    assert float((got.argmax(-1) != ref.argmax(-1)).float().mean()) < 3e-3


def _cells_wd(root, n_cells=3):
    """A working directory of ``n_cells`` cells: a surface-nets bar per cell
    as its mesh and a chain skeleton along it."""
    import os

    from syconn_tpu_torch.backend import MeshStorage, SkeletonStorage
    from syconn_tpu_torch.handler.config import generate_default_conf
    from syconn_tpu_torch.mesh.surface_nets import surface_net_mesh
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset

    wd = os.path.join(root, "wd")
    generate_default_conf(wd, scaling=(10, 10, 20))
    ids = [3 + 4 * i for i in range(n_cells)]
    ssd = SuperSegmentationDataset(working_dir=wd, sv_mapping={i: [i] for i in ids}, create=True)
    rng = np.random.default_rng(0)
    for i in ids:
        sso = ssd.get_super_segmentation_object(i)
        mask = np.zeros((90, 40, 20), bool)
        mask[5:85, 12:26, 5:13] = True
        mask[rng.integers(10, 80):, 5:35, 8:10] = True  # a side branch
        ms = MeshStorage(sso.mesh_path("sv"), read_only=False)
        ms[i] = list(surface_net_mesh(mask, offset=(0, 0, 0), scale=(10, 10, 20)))
        ms.push()
        n = 16
        nodes = np.stack([np.linspace(8, 82, n), np.full(n, 19), np.full(n, 9)], 1)
        ss = SkeletonStorage(sso.skeleton_path, read_only=False)
        ss[i] = {"nodes": nodes.astype(np.float32),
                 "edges": np.stack([np.arange(n - 1), np.arange(1, n)], 1).astype(np.int64),
                 "diameters": np.ones(n, np.float32)}
        ss.push()
    return wd, ids


def test_steps_7_to_9_predictions_card_match_cpu(dev, tmp_path):
    """The step 7-9 predictions on the card against the same functions on
    the CPU in a copy of a toy directory: node and vertex labels of axoness and
    spiness agree on >= 0.98, cell types equal, celltype logits within the
    dense budget, embeddings within 1e-3."""
    import shutil

    from _torch_helpers import port_wd
    from syconn_tpu_torch.inference import points
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset

    wd, ids = _cells_wd(str(tmp_path / "card"))
    wc = str(tmp_path / "cpu")
    shutil.copytree(wd, wc)
    out = {}
    for w, d in ((wd, dev), (wc, "cpu")):
        with port_wd(w) as cfg:
            points.predict_compartments_ssd(skel_key="axoness", n_classes=3, device=d)
            points.predict_compartments_ssd(skel_key="spiness", n_classes=4,
                                            mpath=cfg.mpath_spiness, device=d)
            points.infere_cell_morphology_ssd(device=d)
            points.predict_celltype_ssd(device=d)
        ssd = SuperSegmentationDataset(working_dir=w)
        cells = {}
        for i in ids:
            sso = ssd.get_super_segmentation_object(i)
            sso.load_attr_dict()
            sso.load_skeleton()
            cells[i] = (dict(sso.attr_dict), dict(sso.skeleton))
        out[w] = cells
    for i in ids:
        (ad, sk), (ac, skc) = out[wd][i], out[wc][i]
        for key in ("axoness", "spiness"):
            assert np.mean(sk[key] == skc[key]) >= 0.98, key
            assert np.mean(ad[f"{key}_vertex_labels"] == ac[f"{key}_vertex_labels"]) >= 0.98
        assert ad["celltype_cnn_e3"] == ac["celltype_cnn_e3"]
        lg, lr = torch.from_numpy(ad["celltype_cnn_e3_probas"]), torch.from_numpy(
            ac["celltype_cnn_e3_probas"])
        assert float(((lg - lr).abs() / lr.abs().clamp_min(1e-2)).median()) < 3e-2
        np.testing.assert_allclose(ad["latent_morph"], ac["latent_morph"], rtol=0, atol=1e-3)


@pytest.mark.parametrize("ws,nb_views", [((128, 64), 2), ((256, 128), 2), ((128, 64), 1)])
def test_renderer_card_matches_cpu(dev, ws, nb_views):
    """The splat renderer on the card: depth and index views equal to the
    CPU's (elementwise view transform in a fixed order, exact scatters), on
    a surface-nets blob under PCA rotations with grid ties and vertices
    outside the boxes."""
    from syconn_tpu_torch.mesh.surface_nets import surface_net_mesh
    from syconn_tpu_torch.proc.meshes import calc_rot_matrices
    from syconn_tpu_torch.render.raster import render_views_splat

    g = np.arange(64)
    gx, gy, gz = np.meshgrid(g, g[:48], g[:32], indexing="ij")
    mask = ((gx - 32) / 28.0) ** 2 + ((gy - 24) / 14.0) ** 2 + ((gz - 16) / 10.0) ** 2 <= 1
    _, vert, _ = surface_net_mesh(mask, scale=(10, 10, 20))
    v = vert.reshape(-1, 3)
    rng = np.random.default_rng(0)
    locs = v[rng.choice(len(v), 21)]
    rots = calc_rot_matrices(locs, v, 8000.0)
    ref = render_views_splat(v, locs, rots, 2000.0, ws, nb_views, device="cpu")
    got = render_views_splat(v, locs, rots, 2000.0, ws, nb_views, device=dev)
    assert (ref[1] >= 0).any()
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("name", ["celltype", "tnet", "semseg"])
def test_view_net_card_matches_cpu(dev, name):
    """The view nets at the inference functions' widths, seed-initialised, on the card
    against the CPU on view-like input: logits within the dense budget
    (median relative error < 3e-2, argmax flips < 2e-2 at random init)."""
    from syconn_tpu_torch.models.cmn import MultiViewCMN, TripletCMN, ViewSemSegNet
    from syconn_tpu_torch.models.io import init_model_params

    model = {"celltype": lambda: MultiViewCMN(n_classes=8, widths=(16, 32, 64)),
             "tnet": lambda: TripletCMN(embed_dim=10, widths=(16, 32, 64)),
             "semseg": lambda: ViewSemSegNet(n_classes=3, widths=(16, 32, 64))}[name]()
    init_model_params(model, seed=0)
    rng = np.random.default_rng(1)
    shape = (8, 128, 64, 4) if name == "semseg" else (8, 2, 128, 64, 4)
    x = rng.integers(0, 256, size=shape).astype(np.float32)
    x[rng.random(shape) < 0.5] = 255
    x = torch.from_numpy(x)
    with torch.inference_mode():
        ref = model(x)
        got = model.to(dev)(x.to(dev)).cpu()
    rel = (got - ref).abs() / ref.abs().clamp_min(1e-2)
    assert bool(torch.isfinite(got).all()) and float(rel.median()) < 3e-2
    assert float((got.argmax(-1) != ref.argmax(-1)).float().mean()) < 2e-2


@pytest.mark.parametrize("kind", ["unet", "points", "views"])
def test_train_step_card_matches_cpu(dev, kind):
    """One step of ``models/train.py`` from the same seed initialisation and
    batch on the card and on the CPU: losses within 1e-2 relative, and the
    updated parameters with a median relative difference below 1e-6 (Adam's
    first step moves each parameter by about the learning rate times its
    gradient's sign; a sign that differs moves one by twice the rate)."""
    from syconn_tpu_torch.models.cmn import MultiViewCMN
    from syconn_tpu_torch.models.convert import flax_tree_from_module
    from syconn_tpu_torch.models.pointnet import PointClassNet
    from syconn_tpu_torch.models.train import (make_class_train_step, make_train_state,
                                               make_train_step)
    from syconn_tpu_torch.models.unet3d import UNet3D

    rng = np.random.default_rng(3)
    if kind == "unet":
        build = lambda: UNet3D(features=(32, 64), strides=((2, 2, 2),), patch=(2, 2, 2),  # noqa: E731
                               n_classes=4)
        batch = (rng.integers(0, 255, (2, 32, 32, 16, 1)).astype(np.float32),
                 rng.integers(-1, 4, (2, 32, 32, 16)).astype(np.int32))
        step = make_train_step
    elif kind == "points":
        build = lambda: PointClassNet(n_classes=8, widths=(32, 64))  # noqa: E731
        batch = (rng.normal(size=(4, 256, 7)).astype(np.float32),
                 np.array([0, 1, 3, 7], np.int32))
        step = lambda: make_class_train_step(dict_output=True)  # noqa: E731
    else:
        build = lambda: MultiViewCMN(n_classes=8, widths=(16, 32, 64))  # noqa: E731
        batch = (rng.integers(0, 255, (4, 2, 64, 32, 4)).astype(np.float32),
                 np.array([0, 1, 3, 7], np.int32))
        step = make_class_train_step
    out = []
    for d in ("cpu", dev):
        state = make_train_state(build(), None, learning_rate=1e-3, seed=4, device=d)
        state, m = step()(state, *batch)
        out.append((float(m["loss"]), flax_tree_from_module(state.model)))
    (lc, pc), (lg, pg) = out
    assert np.isfinite(lg) and abs(lg / lc - 1) < 1e-2

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else [v]

    rel = np.concatenate([(np.abs(g - c) / np.maximum(np.abs(c), 1e-3)).ravel()
                          for g, c in zip(leaves(pg), leaves(pc))])
    assert np.median(rel) < 1e-6
