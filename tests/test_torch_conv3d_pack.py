"""Host side of the wgmma conv kernels (ops/conv3d.py): the weight repack, the
head's three-part bf16 split, the per-tensor cache and the Python mirror of
the launcher's tile plan. All of it runs on CPU tensors.

Tolerances: the repack is a permutation (exact). hi + mid + lo reproduces an
f32 weight to 2**-24 relative (three bf16 parts carry 24 mantissa bits); the
three-part product on a bf16 activation equals the f32 product within 1e-6
relative (exact bf16 x bf16 products, f32 sums in another order).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from syconn_tpu_torch.models.convert import kernel_taps
from syconn_tpu_torch.models.io import load_model, packaged_model_path
from syconn_tpu_torch.ops import conv3d as C

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke_shapes():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # imports the standard library only
    return mod.SHAPES


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", val


def _model_kernels(task):
    _, params = load_model(packaged_model_path(task))
    return [(name, np.asarray(val)) for name, val in _leaves(params) if name.endswith("kernel")]


@pytest.mark.parametrize("task", ["syntype", "myelin"])
def test_weight_repack_round_trips_for_the_packaged_models(task):
    seen = set()
    for name, w in _model_kernels(task):
        if w.shape[:3] != (3, 3, 3):
            continue
        taps = kernel_taps(w)
        cin, cout = taps.shape[1:]
        packed = C.pack_conv_weight(taps)
        assert packed.shape == (27, -(-cin // 32), 4, cout, 8) and packed.is_contiguous()
        assert torch.equal(C.unpack_conv_weight(packed, cin), taps), name
        seen.add((cin, cout))
    assert {(32, 64), (64, 64), (128, 64), (128, 128), (64, 128)} <= seen


@pytest.mark.parametrize("cin,cout", [(8, 32), (40, 64), (32, 128), (72, 256)])
def test_weight_repack_pads_the_channels_with_zeros(cin, cout):
    rng = np.random.default_rng(cin + cout)
    w = torch.from_numpy(rng.normal(size=(27, cin, cout)).astype(np.float32)).to(torch.bfloat16)
    packed = C.pack_conv_weight(w)
    nk = -(-cin // 32)
    assert packed.shape == (27, nk, 4, cout, 8)
    assert torch.equal(C.unpack_conv_weight(packed, cin), w)
    # element (tap, k, c) sits at [tap, k // 32, (k % 32) // 8, c, k % 8]
    for k in (0, 7, cin - 1):
        assert torch.equal(packed[5, k // 32, (k % 32) // 8, :, k % 8], w[5, k])
    full = C.unpack_conv_weight(packed, nk * 32)
    assert not bool(full[:, cin:].any())


def test_packed_operands_reproduce_the_conv():
    """The kernel's arithmetic on the packed operands, spelled out with
    tensor ops (a (rows x 32) x (32 x Cout) product per tap and slice),
    against the plain version: same bf16 products, f32 sums in another order."""
    rng = np.random.default_rng(3)
    cin, cout = 40, 32
    x = torch.from_numpy(rng.normal(size=(1, 5, 6, 7, cin)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(27, cin, cout)) / 30).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy((0.1 * rng.normal(size=cout)).astype(np.float32)).to(torch.bfloat16)
    packed = C.pack_conv_weight(w).float()
    nk = packed.shape[1]
    xp = torch.nn.functional.pad(x.float(), (0, nk * 32 - cin, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros((1, 5, 6, 7, cout))
    for t in range(27):
        dx, dy, dz = t // 9, (t // 3) % 3, t % 3
        rows = xp[:, dx:dx + 5, dy:dy + 6, dz:dz + 7]
        for s in range(nk):
            stage = packed[t, s].permute(0, 2, 1).reshape(32, cout)  # [k group][8] x Cout
            acc += rows[..., s * 32:(s + 1) * 32] @ stage
    got = acc.to(torch.bfloat16) + b
    ref = C.conv3x3x3_ln_gelu_ref(x, w, b, epilogue="bias")
    err = (got.float() - ref.float()).abs()
    assert float(err.max()) <= 2.0 ** -6 and float((err > 0).float().mean()) < 0.05


@pytest.mark.parametrize("task", ["syntype", "myelin"])
def test_head_split_reproduces_the_f32_weight(task):
    head = next(w for name, w in _model_kernels(task) if name == "head/kernel")
    hw = torch.from_numpy(head.reshape(head.shape[-2], head.shape[-1]).astype(np.float32))
    parts = C.split_head(hw)
    assert parts.dtype == torch.bfloat16 and parts.shape == (3,) + tuple(hw.shape)
    back = parts[0].double() + parts[1].double() + parts[2].double()
    rel = (back - hw.double()).abs() / hw.double().abs().clamp_min(1e-30)
    assert float(rel.max()) <= 2.0 ** -24


@pytest.mark.parametrize("cout,nh", [(64, 96), (64, 64), (32, 5), (128, 33)])
def test_three_part_head_product_equals_the_f32_product(cout, nh):
    rng = np.random.default_rng(cout * nh)
    y = torch.from_numpy(rng.normal(size=(257, cout)).astype(np.float32)).to(torch.bfloat16)
    hw = torch.from_numpy((rng.normal(size=(cout, nh)) / np.sqrt(cout)).astype(np.float32))
    parts = C.split_head(hw).float()
    got = y.float() @ parts[2] + y.float() @ parts[1] + y.float() @ parts[0]
    ref = y.float() @ hw
    scale = (y.float().abs() @ hw.abs()).clamp_min(1e-30)  # size of the terms summed
    assert float(((got - ref).abs() / scale).max()) <= 1e-6
    packed = C.pack_head(hw)
    nhp = -(-nh // 32) * 32
    assert packed.shape == (3, cout // 8, nhp, 8) and packed.dtype == torch.bfloat16
    unpacked = packed.permute(0, 1, 3, 2).reshape(3, cout, nhp)
    assert torch.equal(unpacked[:, :, :nh], C.split_head(hw))
    assert not bool(unpacked[:, :, nh:].any())


def test_packed_images_are_cached_per_tensor_and_follow_writes():
    w = torch.randn((27, 32, 64)).to(torch.bfloat16)
    first = C._packed(w, "conv", C.pack_conv_weight)
    assert C._packed(w, "conv", C.pack_conv_weight) is first
    w.mul_(2)  # an in-place write bumps the tensor's version: repacked
    second = C._packed(w, "conv", C.pack_conv_weight)
    assert second is not first and torch.equal(C.unpack_conv_weight(second, 32), w)
    key = (id(w), "conv")
    assert key in C._PACKED
    del w, first, second
    assert key not in C._PACKED  # the entry dies with its tensor


SMOKE_SHAPES = _smoke_shapes()
MODES = {"conv3x3x3_ln_gelu": "same", "conv_down2x_bias": "down", "conv_transpose2x_bias": "up"}


@pytest.mark.parametrize("row", SMOKE_SHAPES, ids=lambda r: f"{r[0]}-{r[1]}-{r[2]}-{r[3]}-{r[4]}")
def test_tile_plan_of_every_smoke_shape_fits_shared_memory(row):
    name, _, cin, cout, nh, _, per_tile = row
    plan = C.tile_plan(MODES[name], cin, cout, nh)
    if per_tile > 0 or name != "conv3x3x3_ln_gelu":
        assert plan is not None, "a main-path shape must take the wgmma kernel"
    if plan is not None:
        assert plan["smem_bytes"] <= C.SMEM_LIMIT == 232448
        assert 2 <= plan["stages"] <= 16
        assert plan["halo_bufs"] in ((2, -(-cin // 32)) if name != "conv_down2x_bias" else (4,))
        assert plan["rows"] == plan["brick"][0] * 64 and plan["steps"] == 27 * -(-cin // 32)


def test_smoke_shapes_hold_the_main_path_and_the_tiling_corner_cases():
    assert len(SMOKE_SHAPES) == 23
    assert sum(r[6] for r in SMOKE_SHAPES if r[0] == "conv3x3x3_ln_gelu") == 10
    assert sum(r[6] for r in SMOKE_SHAPES if r[0] == "conv_down2x_bias") == 2
    assert sum(r[6] for r in SMOKE_SHAPES if r[0] == "conv_transpose2x_bias") == 2
    off_path = [r for r in SMOKE_SHAPES if not isinstance(r[1], int)]
    assert {r[3] for r in off_path} >= {32, 64, 256} and any(r[1][0] == 2 for r in off_path)
    down = [r for r in off_path if r[0] == "conv_down2x_bias"]
    # ragged even extents, batch 2, Cout 32 and 256, Cin not a multiple of 32
    assert any(r[1][0] == 2 for r in down) and {r[3] for r in down} >= {32, 256}
    assert any(r[2] % 32 for r in down) and any(s % 16 for r in down for s in r[1][1:])
    assert all(s % 2 == 0 for r in down for s in r[1][1:])


@pytest.mark.parametrize("mode", ["same", "down", "up"])
@pytest.mark.parametrize("cout", [32, 64, 128, 256])
def test_tile_plan_covers_the_contract(mode, cout):
    for cin in (8, 32, 40, 64, 128, 256, 512, 1024):
        plan = C.tile_plan(mode, cin, cout)
        assert plan is not None and plan["smem_bytes"] <= C.SMEM_LIMIT
        if mode == "same":
            for nh in (1, 64, 96, 200):
                head = C.tile_plan(mode, cin, cout, nh)
                assert head is None or (head["smem_bytes"] <= C.SMEM_LIMIT and head["nhp"] >= nh
                                        and head["stages"] >= 2)
                if cout <= 64 and nh <= 96:
                    assert head is not None  # the packaged heads (64 -> 96, 64 -> 64) and smaller
    with pytest.raises(ValueError):
        C.tile_plan(mode, 12, cout)
    with pytest.raises(ValueError):
        C.tile_plan("stride3", 32, cout)
    if mode != "same":
        with pytest.raises(ValueError, match="head"):
            C.tile_plan(mode, 32, cout, 64)


def test_tile_plan_keeps_the_transpose_halo_resident_on_the_main_path():
    assert C.tile_plan("up", 256, 128)["halo_bufs"] == 8   # 20^3, 256 -> 128
    assert C.tile_plan("up", 128, 64)["halo_bufs"] == 4    # 40^3, 128 -> 64
    assert C.tile_plan("up", 1024, 64)["halo_bufs"] == 2   # too many slices: they stream
    assert C.tile_plan("same", 64, 64, 96)["brick"] == (8, 8, 8)
    assert C.tile_plan("same", 256, 256)["brick"] == (2, 8, 8)
    assert C.tile_plan("same", 32, 256, 96) is None        # served by the mma.sync kernel


def test_tile_plan_of_the_stride_2_conv():
    """Both main-path shapes and every Cout: bricks and four small
    input-phase halo buffers fit beside a ring of at least 4 stages."""
    for cin, cout in ((64, 128), (128, 256)):  # 80^3 and 40^3 of the syntype model
        plan = C.tile_plan("down", cin, cout)
        assert plan["halo_bufs"] == 4 and plan["stages"] >= 4
    assert C.tile_plan("down", 64, 128)["brick"] == (4, 8, 8)
    for cout in (32, 64, 128, 256):
        mt = C.DOWN_TILES[cout]
        plan = C.tile_plan("down", 40, cout)
        assert plan["brick"] == (2 * mt, 8, 8)
        assert cout * mt <= 256  # accumulators: mt * Cout / 2 a thread
        assert plan["halo_bytes"] == 4 * 16 * -(-(2 * mt + 1) * 81 // 8) * 8  # 128-byte planes


def _down_tap_table():
    """The stride-2 conv's tap list as conv3d_wgmma.cu walks it (tap_entry):
    input phases (px, py, pz) in order, bit 2 = x; per axis a phase bit 1
    takes tap d = 1, a bit 0 taps 0 and 2; tap d reads halo row r + d // 2 of
    its phase. Entries (tap, phase, delta in 16-byte units in a halo of
    (bx + 1) x 9 x 9 positions)."""
    out = []
    for phase in range(8):
        per_axis = [(1,) if (phase >> s) & 1 else (0, 2) for s in (2, 1, 0)]
        for dx in per_axis[0]:
            for dy in per_axis[1]:
                for dz in per_axis[2]:
                    out.append((dx * 9 + dy * 3 + dz, phase,
                                ((dx // 2) * 9 + dy // 2) * 9 + dz // 2))
    return out


def test_down_tap_table_covers_every_tap_once_in_phase_order():
    table = _down_tap_table()
    assert sorted(t for t, _, _ in table) == list(range(27))
    starts = [next(i for i, e in enumerate(table) if e[1] == p) for p in range(8)]
    assert starts == [0, 8, 12, 16, 18, 22, 24, 26]  # phase_tap0 of the kernel


@pytest.mark.parametrize("shape,cout", [((1, 6, 10, 14, 40), 64), ((2, 10, 6, 18, 32), 256)],
                         ids=["odd-halves-cin40", "batch2-cout256"])
def test_packed_down_operands_reproduce_the_stride_2_conv(shape, cout):
    """The stride-2 conv as the kernel computes it, in numpy: per brick,
    32-channel slice and input phase a halo unit [8-channel
    group][x][y][z][16 B] loaded as the kernel's TMA boxes do (x[2h + p] for
    h in (bx + 1) x 9 x 9, zeros past the input's end: the high pad), and per tap of the phase and 64-row tile
    (one x, 8 y, 8 z) the A operand gathered by descriptor arithmetic: start
    + tile * 81 + delta, SBO 9 units per y, LBO the group plane PS, + k16
    step * 2 PS. Against the plain version: same bf16 products, f32 sums in
    another order. Output half-extents odd, ragged against the 8 x 8 tiles."""
    rng = np.random.default_rng(sum(shape) + cout)
    B, X, Y, Z, cin = shape
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(27, cin, cout)) / 30).astype(np.float32)).to(
        torch.bfloat16)
    b = torch.from_numpy((0.1 * rng.normal(size=cout)).astype(np.float32)).to(torch.bfloat16)
    plan = C.tile_plan("down", cin, cout)
    bx = plan["brick"][0]
    wp = C.pack_conv_weight(w).float().numpy()
    nk = wp.shape[1]
    hp = (bx + 1) * 81
    ps = plan["halo_bytes"] // 64                      # group plane stride, 16-byte units
    assert ps >= hp and ps % 8 == 0                    # TMA boxes land 128-byte aligned
    xs = x.float().numpy()
    OX, OY, OZ = X // 2, Y // 2, Z // 2
    out = np.zeros((B, OX, OY, OZ, cout), np.float32)
    table = _down_tap_table()
    ry, rz = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    rows = (ry * 9 + rz).reshape(64)                   # row r = 8 y + z: + SBO * y + z
    for bb in range(B):
        for x0 in range(0, OX, bx):
            for y0 in range(0, OY, 8):
                for z0 in range(0, OZ, 8):
                    acc = np.zeros((bx, 64, cout), np.float32)
                    for kc in range(nk):
                        for phase in range(8):
                            p = ((phase >> 2) & 1, (phase >> 1) & 1, phase & 1)
                            halo = np.zeros((4 * ps, 8), np.float32)
                            for hx in range(bx + 1):  # the TMA box: every second voxel
                                for hy in range(9):
                                    for hz in range(9):
                                        g = (2 * (x0 + hx) + p[0], 2 * (y0 + hy) + p[1],
                                             2 * (z0 + hz) + p[2])
                                        if g[0] >= X or g[1] >= Y or g[2] >= Z:
                                            continue   # zero fill: the high pad
                                        for v in range(4):
                                            c = kc * 32 + v * 8
                                            if c < cin:
                                                halo[v * ps + (hx * 9 + hy) * 9 + hz] = \
                                                    xs[bb, g[0], g[1], g[2], c:c + 8]
                            for tap, ph, delta in table:
                                if ph != phase:
                                    continue
                                stage = wp[tap, kc].transpose(0, 2, 1).reshape(32, cout)
                                for m in range(bx):
                                    units = m * 81 + delta + rows
                                    a_op = np.concatenate(
                                        [halo[g * ps + units] for g in range(4)], axis=1)
                                    acc[m] += a_op @ stage
                    for m in range(bx):
                        qx = x0 + m
                        if qx >= OX:
                            continue
                        blk = acc[m].reshape(8, 8, cout)[:OY - y0, :OZ - z0]
                        out[bb, qx, y0:y0 + 8, z0:z0 + 8] = blk
    got = torch.from_numpy(out).to(torch.bfloat16) + b
    ref = C.conv_down2x_bias_ref(x, w, b)
    assert got.shape == ref.shape == (B, OX, OY, OZ, cout)
    err = (got.float() - ref.float()).abs()
    assert float(err.max()) <= 2.0 ** -6 and float((err > 0).float().mean()) < 0.05
