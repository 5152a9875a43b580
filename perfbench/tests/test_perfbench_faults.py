"""The check catches the faults a cell can have.

Each test drives a whole run of a cell on the CPU (the program's plain
versions, small shapes, the look for a card skipped) with the timed path
broken underneath, and sees ``correct`` come out false; the same run
unbroken comes out correct.
"""

import pytest
import torch

from _perfbench_names import CELLS
from perfbench.lib import harness


@pytest.fixture()
def run(root, small):
    def go(workload, seed=2**31 + 7):
        torch.set_num_threads(2)
        ov = small
        if workload == "syntype.device.mesh4":
            # the device route over a 4-way data mesh (no cell of its own yet)
            workload = "syntype.device"
            ov = dict(small, chips=4, traffic=dict(small["traffic"], data_mesh=4))
        return harness.run(root, workload, seed, 0.3, False, device="cpu", overrides=ov,
                           log=lambda m: None)
    return go


@pytest.mark.parametrize("workload", CELLS + ["syntype.device.mesh4"])
def test_sound_run_is_correct(run, workload):
    r = run(workload)
    assert r["correct"] and r["failed"] == 0, r["limits"]
    assert r["attempted"] == r["window"]["passes"] * 12  # a 3 x 2 x 2 tile grid
    assert r["window"]["tiles_compared"] == 12


def test_stale_output_device(run, monkeypatch):
    """A pass that returns an earlier pass's result instead of predicting."""
    from syconn_tpu_torch.inference import dense

    first = {}
    real = dense.ResidentDensePredictor.predict_volume_packed

    def stale(self, vol):
        if "out" not in first:
            first["out"] = real(self, vol)
        return first["out"]

    monkeypatch.setattr(dense.ResidentDensePredictor, "predict_volume_packed", stale)
    assert not run("syntype.device")["correct"]


def test_no_window_pass_gets_the_warm_up_input(root):
    """The device route's shift wraps past the volume's x extent without
    coming back to the warm-up pass's 0, so an output kept from the warm-up
    never matches a window pass's input (a window of 72 passes did at the
    small shapes' 72 voxels)."""
    route = harness.Cell(root, "syntype.device").route
    state = {"base": torch.arange(5 * 2 * 2).reshape(5, 2, 2)}
    assert torch.equal(route._volume(state, 0), state["base"])
    for p in range(1, 30):
        assert not torch.equal(route._volume(state, p), state["base"]), p
    assert torch.equal(route._volume(state, 3), torch.roll(state["base"], 3, 0))


def test_stale_output_store(run, monkeypatch):
    """A pass that writes nothing (the targets were removed before it)."""
    from syconn_tpu_torch.exec import exec_dense_prediction

    monkeypatch.setattr(exec_dense_prediction, "predict_dense_to_kd",
                        lambda *a, **kw: {"mvox_per_s": 1.0, "dispatches": 0})
    r = run("organelles.store")
    assert not r["correct"] and r["window"]["missing"]


def test_half_the_batch_left_out(run, monkeypatch):
    """Each batch forwards its first half and repeats it for the rest."""
    from syconn_tpu_torch.inference import dense

    real = dense.DenseTilePredictor._forward

    def half(self, x):
        h = max(1, x.shape[0] // 2)
        out = real(self, x[:h])
        return torch.cat([out] * (-(-x.shape[0] // h)))[:x.shape[0]]

    monkeypatch.setattr(dense.DenseTilePredictor, "_forward", half)
    assert not run("syntype.device")["correct"]


def test_exchange_between_cards_left_out(run, monkeypatch):
    """The gather keeps the first card's shard in place of the others'."""
    from syconn_tpu_torch.inference import dense

    monkeypatch.setattr(dense, "gather",
                        lambda shards, device, dim=0: torch.cat([shards[0]] * len(shards), dim))
    assert not run("syntype.device.mesh4")["correct"]


@pytest.mark.parametrize("workload", ["syntype.device", "organelles.store"])
def test_answer_altered_where_it_is_produced(run, workload, monkeypatch):
    """The first tile of every batch comes out with its probabilities
    mirrored (255 - p)."""
    from syconn_tpu_torch.inference import dense

    real = dense.DenseTilePredictor._forward_on

    def altered(self, x, *args):
        out = real(self, x, *args).clone()
        out[0] = 255 - out[0]
        return out

    monkeypatch.setattr(dense.DenseTilePredictor, "_forward_on", altered)
    assert not run(workload)["correct"]
