"""A traced stretch whose device trace did not keep the card's clock: the
distance of the marker kernels after the stretch's end in the trace, against
the CUDA events' elapsed time, the stretch traced again, and the device-time
readers left silent where no stretch kept the clock."""

import json

import pytest
import torch

from perfbench.lib import harness, readers
from perfbench.lib import trace as tr


def _chrome(path, scale, markers=3):
    """A chrome trace of one card: the stretch's marks 1 s apart on the host, a
    conv kernel between them, and after the end the clock's three marker
    kernels (short, a 100 ms spin, short), every device time multiplied by
    ``scale``."""
    ev = [dict(ph="X", cat="user_annotation", name=tr.START, ts=0.0, dur=1.0),
          dict(ph="X", cat="user_annotation", name=tr.END, ts=1e6, dur=1.0)]
    for t, d in ((1.01e6, 1.0), (1.01e6 + 2.0, 1e5), (1.01e6 + 1e5 + 3.0, 1.0))[:markers]:
        ev.append(dict(ph="X", cat="kernel", name="at::cuda::(anonymous namespace)::spin_kernel(long)",
                       ts=t * scale, dur=d * scale, args={"device": 0}))
    ev.append(dict(ph="X", cat="kernel", name="conv3d_wgmma_kernel", ts=2e5 * scale,
                   dur=5e5 * scale, args={"device": 0}))
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


@pytest.mark.parametrize("scale, markers, ratio, complete",
                         [(1.0, 3, 1.0, True), (0.48, 3, 0.48, False), (1.0, 2, None, False)],
                         ids=["kept", "halved", "marker_lost"])
def test_clock_ratio_from_the_markers(tmp_path, scale, markers, ratio, complete):
    t = tr.load(_chrome(tmp_path / "t.json", scale, markers), {tr.START: 0}, {0: 0.100003})
    assert t.clock_ratio[0] == (pytest.approx(ratio) if ratio is not None else None)
    assert t.complete is complete
    # the markers are the harness's, not the program's: no metric sees them
    assert [e["name"] for e in t.events] == ["conv3d_wgmma_kernel"]


def test_a_trace_without_device_marks_is_taken_as_it_is(tmp_path):
    t = tr.load(_chrome(tmp_path / "t.json", 0.48), {tr.START: 0})
    assert t.clock_ratio == {} and t.complete


class _Ctx:
    def __init__(self, trace, family):
        self.trace_data = trace
        self.family = family
        self.stretch_passes, self.tiles_per_pass = 1, 2
        self.card_indices, self.n_cards = [0], 1
        self.arch = {"features": [32, 64], "strides": [[2, 2, 2]], "patch": [2, 2, 2],
                     "n_classes": 4}
        self.window_shape = [320, 320, 160]
        self.device = torch.device("cuda", 0)


def test_device_time_readers_are_silent_on_an_incomplete_trace(unet3d):
    ev = [dict(name="softmax", cat="kernel", ts=10.0, dur=30.0, device=0)]
    ctx = _Ctx(tr.Trace(ev, 0.0, 100.0, 0, {0: 1.001}), unet3d)
    assert readers.idle_share(ctx) == pytest.approx(70.0)
    assert readers.other_ms_per_tile(ctx) == pytest.approx(30e-3 / 2)
    ctx.trace_data = tr.Trace(ev, 0.0, 100.0, 0, {0: 0.48})
    assert readers.idle_share(ctx) is None and readers.other_ms_per_tile(ctx) is None


@pytest.mark.parametrize("ratios, kept", [([0.48, 1.0], 2), ([0.48, 0.5, 0.47], None)],
                         ids=["second_stretch_kept", "none_kept"])
def test_a_stretch_that_lost_the_clock_is_traced_again(root, small, monkeypatch, ratios, kept):
    """The CPU run's stretches get traces whose clock ratios are ``ratios``
    in turn: each one off is traced again from the next pass, up to
    ``TRACE_ATTEMPTS`` stretches; where none kept the clock the device-time
    metrics are left out of the line."""
    loads = []

    def fake_load(prof):
        loads.append(dict(prof.marks))
        return tr.Trace([], 0.0, 1e6, prof.marks[tr.START], {0: ratios[len(loads) - 1]})

    monkeypatch.setattr(harness, "load_stretch", fake_load)
    torch.set_num_threads(2)
    r = harness.run(root, "organelles.device", 2**31 + 23, 0.3, True, device="cpu",
                    overrides=small, log=lambda m: None)
    assert len(loads) == len(ratios) == len(r["window"]["trace_clock"])
    assert [c[0] for c in r["window"]["trace_clock"]] == ratios
    assert r["correct"]
    # two passes a stretch (traffic/device.json), each stretch traced anew
    assert r["window"]["passes"] >= 2 * len(ratios)
    if kept:
        assert "idle_share.device.organelles" in r["metrics"]
    else:
        assert "idle_share.device.organelles" not in r["metrics"]
        assert "conv3d_roofline.device.organelles" not in r["metrics"]


def test_step_mfu_leaves_out_every_traced_stretch(unet3d):
    """Passes 1 and 3 were traced (a stretch of one pass traced again):
    both are left out of the whole step's share."""
    from perfbench.lib import frozen

    ctx = _Ctx(None, unet3d)
    ctx.pass_seconds, ctx.traced_passes = [0.5, 0.9, 0.5, 0.8, 0.5], [1, 3]
    flops = frozen.unet_flops(ctx.arch, [1] + ctx.window_shape) * 2
    assert readers.step_mfu(ctx) == pytest.approx(100.0 * flops * 3 / 1.5 / frozen.PEAK_FLOPS)
