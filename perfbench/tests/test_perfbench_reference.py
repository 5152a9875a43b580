"""The plain reference against the program's CPU path, and the control
(the reference in float8) against the limits of ``correct``."""

import numpy as np
import pytest
import torch

from _perfbench_names import CELLS
from perfbench.lib import harness, inputs
from perfbench.reference import dense as ref_dense
from perfbench.reference import unet as ref_unet

TINY = {"features": [8, 16, 32], "strides": [[2, 2, 2], [2, 2, 2]], "patch": [4, 4, 2],
        "n_classes": 3}


def _port_model(arch, params):
    from syconn_tpu_torch.models.convert import module_state_from_flax
    from syconn_tpu_torch.models.unet3d import UNet3D

    m = UNet3D(features=arch["features"], strides=arch["strides"], patch=arch["patch"],
               n_classes=arch["n_classes"])
    m.load_state_dict(module_state_from_flax(inputs.host_tree(params)))
    return m


@pytest.mark.parametrize("arch", [TINY, {"features": [8, 16], "strides": [[2, 2, 2]],
                                         "patch": [2, 2, 2], "n_classes": 4}])
def test_reference_logits_agree_with_the_port_at_a_tiny_width(arch):
    torch.manual_seed(0)
    params = inputs.make_params(arch, 2**31 + 11, "cpu")
    x = inputs.em_volume((32, 32, 16), 5, "cpu")
    ref = ref_unet.logits_packed(arch, params, x)                   # (Nh, sx, sy, sz) f32
    with torch.no_grad():
        port = _port_model(arch, params)(x[None, ..., None], full_res=False)[0]
    port = port.permute(3, 0, 1, 2)
    # the port rounds every activation to bf16 (8 bits of mantissa): its
    # logits lie ~1% of their spread off the float32 reference on average
    scale = float(ref.std())
    assert float((ref - port).abs().max()) < 0.3 * scale
    assert float((ref - port).abs().mean()) < 0.02 * scale
    # the fp8 control is an order of magnitude further off
    low = ref_unet.logits_packed(arch, params, x, "fp8")
    assert float((low - ref).abs().mean()) > 5 * float((ref - port).abs().mean())


def test_reference_tiles_agree_with_the_ported_predictor(unet3d):
    from syconn_tpu_torch.inference.dense import ResidentDensePredictor
    from syconn_tpu_torch.models.unet3d import UNet3D

    params = inputs.make_params(TINY, 3, "cpu")
    vol = inputs.em_volume((72, 40, 24), 4, "cpu")
    tile, halo = (32, 32, 16), (8, 8, 4)
    model = UNet3D(**{k: TINY[k] for k in ("features", "strides", "patch", "n_classes")})
    pred = ResidentDensePredictor(model, inputs.host_tree(params), tile_shape=tile, halo=halo,
                                  device="cpu")
    packed, grid = pred.predict_volume_packed(vol)
    gaps = []
    for off in ref_dense.tile_offsets(vol.shape, tile):
        ext, ref = ref_dense.predict_tile(
            lambda w, p: unet3d.reference_forward(TINY, params, w, p), vol, off, tile, halo)
        for ch in range(3):
            port = pred.class_volume_device(packed, grid, ch, tuple(vol.shape))
            sl = tuple(slice(o, o + e) for o, e in zip(off, ext))
            gaps.append((port[sl].int() - ref[ch].int()).abs())
    gaps = torch.cat([g.reshape(-1) for g in gaps])
    assert int(gaps.max()) <= 3 and float(gaps.float().mean()) < 0.5


def test_mag2_is_the_floor_of_the_mean():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 256, (6, 5, 4), dtype=np.uint8)
    got = ref_dense.mag2_tile(torch.from_numpy(v)).numpy()
    p = np.pad(v.astype(np.float32), [(0, 0), (0, 1), (0, 0)], mode="edge")
    want = p.reshape(3, 2, 3, 2, 2, 2).mean(axis=(1, 3, 5)).astype(np.uint8)
    assert np.array_equal(got, want)


def test_window_pads_with_zeros_outside_the_volume():
    vol = torch.arange(4 * 4 * 2, dtype=torch.uint8).reshape(4, 4, 2) + 1
    w = ref_dense.window(vol, (0, 0, 0), (4, 4, 2), (2, 1, 1))
    assert w.shape == (8, 6, 4)
    assert int(w[:2].sum()) == 0 and torch.equal(w[2:6, 1:5, 1:3], vol)


SMALL_FULL_WIDTH = {"config": {"tile": [64, 64, 32], "halo": [32, 32, 16]},
                    "traffic": {"volume": [96, 64, 32], "judge_tiles": 2}}


@pytest.mark.parametrize("workload", ["organelles.device", "organelles.store"])
def test_control_fails_and_the_program_passes_at_full_width(root, workload):
    """The control (the reference in float8 in the program's place) reads
    above the cell's limits; the program's plain versions below them."""
    from perfbench import calibrate

    torch.set_num_threads(2)
    cell = harness.Cell(root, workload, SMALL_FULL_WIDTH)
    prog = calibrate.reading(cell, 2**31 + 1, False, "cpu")["numbers"]
    ctrl = calibrate.reading(cell, 2**31 + 1, True, "cpu")["numbers"]
    assert all(prog[n] <= lim for n, lim in cell.limits.items()), (prog, cell.limits)
    assert any(ctrl[n] > lim for n, lim in cell.limits.items()), (ctrl, cell.limits)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_own_size(root, workload, card):
    from perfbench import calibrate

    cell = harness.Cell(root, workload)
    ctrl = calibrate.reading(cell, 2**31 + 3, True, "cuda")["numbers"]
    assert any(ctrl[n] > lim for n, lim in cell.limits.items()), (ctrl, cell.limits)
