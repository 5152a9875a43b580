"""The ``nnunet`` model family: its plain reference against the program's
CPU path at a tiny width, the float8 control further off; its counts, and
its launch plan against the engine's calls; the instance-norm readers on a
synthetic stretch (a share of the roofline only where the program recorded
one span a norm)."""

import os

import pytest
import torch

from _perfbench_names import CONFIG
from perfbench.lib import frozen, harness, program_spans
from perfbench.lib import trace as tr

CELL = "nnunet_fullres.device"
TINY = dict(CONFIG["nnunet_fullres"]["arch"], features=[8, 16, 32],
            strides=[[1, 1, 1], [2, 2, 2], [2, 2, 2]])


@pytest.fixture()
def family():
    return harness.load_module(os.path.join(harness.BENCH_DIR, "families", "nnunet.py"),
                               "perfbench_family_nnunet")


def test_reference_agrees_with_the_port_at_a_tiny_width(family):
    from syconn_tpu_torch.models import nnunet_engine as E

    torch.set_num_threads(2)
    params = family.make_params(TINY, 2**31 + 13, "cpu")
    model, host = family.program_model(TINY, params, "cpu")
    g = torch.Generator().manual_seed(3)
    x = torch.randint(0, 256, (20, 16, 12), generator=g, dtype=torch.uint8)
    lg = E.nnunet_apply_packed(model, E.device_params(host, "cpu"), x[None, ..., None])[0]
    port = torch.round(torch.softmax(lg.permute(3, 0, 1, 2), 0) * 255.0).to(torch.uint8)
    ref = family.reference_forward(TINY, params, x, "f32")
    gap = (port.int() - ref.int()).abs().float()
    # bf16 activations against float32: a few steps at the worst voxel
    assert float(gap.max()) <= 6 and float(gap.mean()) < 0.6
    low = family.reference_forward(TINY, params, x, "fp8")
    assert float((low.int() - ref.int()).abs().float().mean()) > 3 * float(gap.mean())


def test_counts(family):
    arch = CONFIG["nnunet_fullres"]["arch"]
    # 0.955 TFLOP a 128^3 window, 455 kFLOP a voxel; linear in the batch
    assert family.flops(arch, [1, 128, 128, 128]) == pytest.approx(0.9547e12, rel=1e-3)
    assert family.flops(arch, [4, 128, 128, 128]) == 4 * family.flops(arch, [1, 128, 128, 128])
    launches = family.conv_launches(arch, [1, 128, 128, 128])
    kinds = [x["kind"] for x in launches]
    assert kinds.count("same") == 17 and kinds.count("down") == 5 and kinds.count("up2") == 5
    head = 2 * 128 ** 3 * 32 * 4
    assert sum(x["flops"] for x in launches) + head == family.flops(arch, [1, 128, 128, 128])
    norms = family.norm_layers(arch, [4, 128, 128, 128])
    assert len(norms) == 22 and norms[0]["voxels"] == 4 * 128 ** 3
    assert [n["channels"] for n in norms[:12]] == [32, 32, 64, 64, 128, 128, 256, 256, 320, 320,
                                                   320, 320]


def test_engine_makes_the_familys_launches(family, monkeypatch):
    """The engine's conv and norm calls, in order, are the family's plan."""
    from syconn_tpu_torch.models import nnunet_engine as E

    torch.set_num_threads(2)
    arch = TINY
    params = family.make_params(arch, 5, "cpu")
    model, host = family.program_model(arch, params, "cpu")
    seen = []
    for name, kind in (("conv3x3x3_ln_gelu", "same"), ("conv_down2x_bias", "down"),
                       ("conv_transpose2x2_bias", "up2"), ("instance_norm_lrelu", "norm")):
        real = getattr(E, name)

        def wrap(*a, _real=real, _kind=kind, **kw):
            seen.append(_kind)
            return _real(*a, **kw)

        monkeypatch.setattr(E, name, wrap)
    E.nnunet_apply_packed(model, E.device_params(host, "cpu"),
                          torch.zeros((1, 16, 16, 16, 1), dtype=torch.uint8))
    assert [k for k in seen if k != "norm"] == [x["kind"] for x in
                                                family.conv_launches(arch, [1, 16, 16, 16])]
    assert seen.count("norm") == len(family.norm_layers(arch, [1, 16, 16, 16]))


class _Ctx:
    """A stretch of one pass of 3 tiles: two forwards (batch 2 and 1) of
    16^3 windows at TINY."""

    def __init__(self, family, events):
        self.family, self.arch = family, TINY
        self.trace_data = tr.Trace(events, 0.0, 1000.0, host_anchor_ns=1_000_000)
        self.stretch_spans = [dict(name="forward_on", t0=0, t1=1, batch=b) for b in (2, 1)]
        self.window_shape = [16, 16, 16]
        self.stretch_passes, self.tiles_per_pass = 1, 3


def _norm_records(n, device_s=1e-5):
    return [dict(name="engine.norm", t0=1_000_000 + 10 * i, t1=1_000_000 + 10 * i + 5, thread=1,
                 id=i, parent=None, call=0, attrs={}, device_s=device_s) for i in range(n)]


def test_instnorm_readers(root, family, monkeypatch):
    ev = [dict(name=f"void (anonymous namespace)::{k}(...)", cat="kernel", ts=float(i), dur=2.0,
               device=0) for i, k in enumerate(family.NORM_KERNELS * 20)]
    ev.append(dict(name="void conv3d_wgmma_kernel<3, 64, 4, 1>", cat="kernel", ts=90.0,
                   dur=50.0, device=0))
    ctx = _Ctx(family, ev)
    cell = harness.Cell(root, CELL)
    per_forward = len(family.norm_layers(TINY, [1, 16, 16, 16]))
    monkeypatch.setattr(program_spans, "program_records", lambda: _norm_records(2 * per_forward))
    bound = sum(x["bytes"] for b in (2, 1) for x in family.norm_layers(TINY, [b, 16, 16, 16]))
    want = 100.0 * bound / frozen.PEAK_BYTES / (40 * 2e-6)
    assert cell.reader("instnorm_roofline.device.nnunet_fullres").read(ctx) == \
        pytest.approx(want)
    # 2 * 10 norms of 10 us over 3 tiles
    assert cell.reader("instnorm_ms_per_tile.device.nnunet_fullres").read(ctx) == \
        pytest.approx(1e3 * 2 * per_forward * 1e-5 / 3)
    # a span missing (or a program without the spans): no share
    monkeypatch.setattr(program_spans, "program_records",
                        lambda: _norm_records(2 * per_forward - 1))
    assert cell.reader("instnorm_roofline.device.nnunet_fullres").read(ctx) is None
    monkeypatch.setattr(program_spans, "program_records", lambda: [])
    assert cell.reader("instnorm_roofline.device.nnunet_fullres").read(ctx) is None
    assert cell.reader("instnorm_ms_per_tile.device.nnunet_fullres").read(ctx) is None
