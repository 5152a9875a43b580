"""The harness: cells resolve their files by name, names and units keep to
the contract's characters, the frozen yardstick matches the program's
arithmetic, the trace arithmetic is right, and a run without a card fails
without a result."""

import json
import os
import re
import subprocess
import sys

import pytest

from _perfbench_names import BENCH, CELLS, UNET3D_CONFIGS
from perfbench.lib import frozen, harness, readers
from perfbench.lib import trace as tr

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_keys_names_and_units():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["perfbench"] and b["command"][1] == "perfbench/run.py"
    metrics = b["end_to_end"] + b["per_layer"]
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert 0 < len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
    for m in metrics:
        assert set(m.get("workloads", [])) <= set(CELLS), m


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_its_files(root, workload):
    cell = harness.Cell(root, workload)
    for attr in ("SPANS", "setup", "run_pass", "judge"):
        assert hasattr(cell.route, attr)
    assert cell.arch and cell.config["mapping"]
    for attr in ("make_params", "program_model", "reference_forward", "flops", "conv_launches"):
        assert callable(getattr(cell.family, attr))
    assert cell.family.CONV_KERNELS
    # the rate is an end-to-end metric that lists the cell
    rate = {m["name"]: m for m in BENCH["end_to_end"]}[cell.rate_metric]
    assert workload in rate["workloads"]
    layers = cell.per_layer()
    assert layers
    for m in layers:
        assert callable(cell.reader(m["name"]).read)
    assert set(cell.limits) >= {"mean_abs_lsb", "max_abs_lsb"}


@pytest.mark.parametrize("name", UNET3D_CONFIGS)
def test_frozen_flops_equal_the_programs(root, name):
    from syconn_tpu_torch.models.unet3d import UNet3D
    from syconn_tpu_torch.models.unet_engine import unet_flops

    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    a = cfg["arch"]
    model = UNet3D(features=a["features"], strides=a["strides"], patch=a["patch"],
                   n_classes=a["n_classes"])
    for shape in ([1, 320, 320, 160], [4, 320, 320, 160]):
        assert frozen.unet_flops(a, shape) == unet_flops(model, shape)
    launches = frozen.conv_launches(a, [1, 320, 320, 160])
    depth = len(a["features"])
    kinds = [x["kind"] for x in launches]
    assert kinds.count("same") == 4 * depth - 2
    assert kinds.count("down") == kinds.count("up") == depth - 1
    # the launches' operations are the whole forward's
    assert sum(x["flops"] for x in launches) == frozen.unet_flops(a, [1, 320, 320, 160])


def _synthetic_trace():
    # card 0: two kernels overlapping in [10, 40] and one at [60, 70] us,
    # inside a stretch [0, 100]; a copy on card 1 cut to [0, 20]
    ev = [dict(name="void conv3d_wgmma_kernel<0, 64, 4>", cat="kernel", ts=10.0, dur=20.0, device=0),
          dict(name="elementwise", cat="kernel", ts=25.0, dur=15.0, device=0),
          dict(name="void conv3d_kernel<0>", cat="kernel", ts=60.0, dur=10.0, device=0),
          dict(name="Memcpy DtoD (Device -> Device)", cat="gpu_memcpy", ts=-5.0, dur=25.0,
               device=1)]
    return tr.Trace(tr.clip(ev, 0.0, 100.0), 0.0, 100.0, host_anchor_ns=0)


def test_trace_arithmetic_on_a_synthetic_trace():
    t = _synthetic_trace()
    assert tr.busy_intervals(t, 0) == [(10.0, 40.0), (60.0, 70.0)]
    assert tr.busy_s(t, [0]) == pytest.approx(40e-6)
    assert tr.idle_share(t, [0]) == pytest.approx(60.0)
    assert tr.idle_share(t, [0, 1]) == pytest.approx(100.0 * (1 - (40 + 20) / 2 / 100))
    assert tr.gaps(t, 0) == [(0.0, 10.0), (40.0, 60.0), (70.0, 100.0)]
    assert len(tr.matching(t, frozen.CONV_KERNELS)) == 2
    assert [e["dur"] for e in t.events if e["device"] == 1] == [20.0]
    spans = [dict(name="save_raw", t0=35_000, t1=80_000), dict(name="unpack", t0=0, t1=5_000)]
    gaps = tr.labelled_gaps(t, [0], spans)
    assert gaps[0] == ["host", pytest.approx(30e-6)]
    assert ["save_raw", pytest.approx(20e-6)] in gaps and ["unpack", pytest.approx(10e-6)] in gaps


class _Ctx:
    """What the readers see, for a synthetic stretch of one pass of one
    forward of batch 1."""

    def __init__(self, trace, family):
        import torch

        self.trace_data = trace
        self.family = family
        self.arch = {"features": [32, 64], "strides": [[2, 2, 2]], "patch": [2, 2, 2],
                     "n_classes": 4}
        self.window_shape = [320, 320, 160]
        self.stretch_spans = [dict(name="forward_on", t0=0, t1=1, batch=1)]
        self.stretch_passes, self.tiles_per_pass = 1, 2
        self.card_indices, self.n_cards = [0], 1
        self.window_passes, self.window_seconds = 4, 2.4
        # the second pass is the traced one, slowed by the profiler
        self.pass_seconds, self.traced_passes = [0.5, 0.9, 0.5, 0.5], [1]
        self.device = torch.device("cuda", 0)
        self.voxels_per_pass = 10 ** 9


def test_roofline_and_per_tile_arithmetic(unet3d):
    a = {"features": [32, 64], "strides": [[2, 2, 2]], "patch": [2, 2, 2], "n_classes": 4}
    launches = frozen.conv_launches(a, [1, 320, 320, 160])
    ev = [dict(name="conv3d_wgmma_kernel", cat="kernel", ts=float(i), dur=1.0, device=0)
          for i in range(len(launches))]
    ev.append(dict(name="softmax", cat="kernel", ts=50.0, dur=3.0, device=0))
    ctx = _Ctx(tr.Trace(ev, 0.0, 100.0, 0), unet3d)
    bound = sum(frozen.launch_bound_s(x) for x in launches)
    assert readers.conv_roofline(ctx) == pytest.approx(100.0 * bound / (len(launches) * 1e-6))
    assert readers.other_ms_per_tile(ctx) == pytest.approx(3e-3 / 2)
    assert readers.idle_share(ctx) == pytest.approx(100.0 - len(launches) - 3.0)
    # three untraced passes of two tiles in 1.5 s
    mfu = frozen.unet_flops(a, [1, 320, 320, 160]) * 2 * 3 / 1.5 / frozen.PEAK_FLOPS * 100
    assert readers.step_mfu(ctx) == pytest.approx(mfu)
    # one launch more or fewer than the frozen plan: the roofline is not read
    ctx.trace_data = tr.Trace(ev[1:], 0.0, 100.0, 0)
    assert readers.conv_roofline(ctx) is None
    ctx.stretch_spans = [dict(name="unpack", t0=0, t1=2_000_000_000)]
    assert readers.thread_s_per_gvx(ctx, "unpack") == pytest.approx(2.0)
    assert readers.thread_s_per_gvx(ctx, "save_raw") is None


def test_run_without_a_card_exits_without_a_result(root):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "syntype.device",
                        "--seed", "2147483653", "--seconds", "1", "--trace", "0"],
                       cwd=root, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "needs 1 CUDA card" in p.stderr and "no CPU fallback" in p.stderr
