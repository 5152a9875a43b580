"""The readers of the program's own spans on synthetic records and a
synthetic trace: the stretch filter, each sum and divisor, the writes per
chunk, and None without a trace, a tracer or the span."""

import pytest

from perfbench.lib import harness, program_spans
from perfbench.lib import trace as tr


class _Ctx:
    """A stretch of 2 passes of 4 tiles and 0.5 GVx each, on a trace whose
    [0, 100] us is host [1_000_000, 1_100_000] ns."""

    def __init__(self):
        self.trace_data = tr.Trace([], 0.0, 100.0, host_anchor_ns=1_000_000)
        self.stretch_passes, self.tiles_per_pass = 2, 4
        self.voxels_per_pass = 5 * 10 ** 8


def _rec(name, t0, t1, device_s=None, **attrs):
    return dict(name=name, t0=1_000_000 + t0, t1=1_000_000 + t1, thread=1, id=0, parent=None,
                call=0, attrs=attrs, device_s=device_s)


RECORDS = [
    # inside the stretch (host ns 0..100_000 after the anchor)
    _rec("chunk.compress", 1_000, 31_000),
    _rec("chunk.compress", 40_000, 50_000),
    _rec("chunk.rmw_read", 2_000, 4_000),
    _rec("chunk.write", 1_000, 32_000, key="/mi/raw/mag1/c_0_0_0.zst", rmw=False),
    _rec("chunk.write", 33_000, 40_000, key="/mi/raw/mag2/c_0_0_0.zst", rmw=True),
    _rec("chunk.write", 41_000, 50_000, key="/mi/raw/mag2/c_0_0_0.zst", rmw=True),
    _rec("engine.head", 10_000, 11_000, device_s=0.002),
    _rec("engine.head", 20_000, 21_000, device_s=0.004),
    _rec("resident.stack", 1_000, 2_000, device_s=0.001),
    _rec("resident.concat", 60_000, 61_000, device_s=0.0005),
    _rec("resident.reassembly", 70_000, 80_000, device_s=0.0025),
    # outside it: before, straddling the start, straddling the end, after
    _rec("chunk.compress", -50_000, -10_000),
    _rec("chunk.compress", -1_000, 5_000),
    _rec("chunk.write", 90_000, 120_000, key="/vc/raw/mag1/c_0_0_0.zst", rmw=False),
    _rec("engine.head", 200_000, 210_000, device_s=1.0),
]


@pytest.fixture()
def ctx(monkeypatch):
    monkeypatch.setattr(program_spans, "program_records", lambda: [dict(r) for r in RECORDS])
    return _Ctx()


def test_stretch_filter(ctx):
    kept = program_spans.in_stretch(ctx)
    assert len(kept) == 11
    assert all(0.0 <= ctx.trace_data.host_us(r["t0"]) and
               ctx.trace_data.host_us(r["t1"]) <= 100.0 for r in kept)


def test_thread_seconds_per_gvx(ctx):
    # 40 us of compression over 2 passes x 0.5 GVx
    assert program_spans.thread_s_per_gvx(ctx, "chunk.compress") == pytest.approx(40e-6 / 1.0)
    assert program_spans.thread_s_per_gvx(ctx, "chunk.rmw_read") == pytest.approx(2e-6)
    assert program_spans.thread_s_per_gvx(ctx, "chunk.lock_wait") is None


def test_writes_per_chunk(ctx):
    # 3 writes in the stretch to 2 distinct chunks; the write straddling the
    # end is left out
    assert program_spans.writes_per_chunk(ctx) == pytest.approx(1.5)


def test_device_ms_per_tile(ctx):
    # 6 ms of head over 8 tiles; 4 ms of copies over 8 tiles
    assert program_spans.device_ms_per_tile(ctx, ("engine.head",)) == pytest.approx(0.75)
    names = ("resident.stack", "resident.concat", "resident.reassembly")
    assert program_spans.device_ms_per_tile(ctx, names) == pytest.approx(0.5)
    assert program_spans.device_ms_per_tile(ctx, ("engine.forward",)) is None


def test_device_ms_per_tile_without_device_time(ctx, monkeypatch):
    # spans recorded on the CPU carry no device time
    monkeypatch.setattr(program_spans, "program_records",
                        lambda: [dict(r, device_s=None) for r in RECORDS])
    assert program_spans.device_ms_per_tile(ctx, ("engine.head",)) is None


def test_none_without_a_trace(ctx):
    ctx.trace_data = None
    assert program_spans.in_stretch(ctx) is None
    assert program_spans.thread_s_per_gvx(ctx, "chunk.compress") is None
    assert program_spans.writes_per_chunk(ctx) is None
    assert program_spans.device_ms_per_tile(ctx, ("engine.head",)) is None


def test_none_without_the_tracer(ctx, monkeypatch):
    # a program older than the tracer
    monkeypatch.setattr(program_spans, "program_records", lambda: None)
    assert program_spans.thread_s_per_gvx(ctx, "chunk.compress") is None
    assert program_spans.writes_per_chunk(ctx) is None


@pytest.mark.parametrize("metric,value", [
    ("chunk_compress_thread_s_per_gvx.store", 40e-6),
    ("chunk_rmw_read_thread_s_per_gvx.store", 2e-6),
    ("chunk_lock_wait_thread_s_per_gvx.store", None),
    ("mag_downsample_thread_s_per_gvx.store", None),
    ("chunk_writes_per_chunk.store", 1.5),
    ("head_ms_per_tile.device.syntype", 0.75),
    ("head_ms_per_tile.device.organelles", 0.75),
    ("tile_copy_ms_per_tile.device.syntype", 0.5),
    ("tile_copy_ms_per_tile.device.organelles", 0.5),
])
def test_metric_files_read_the_spans(root, ctx, metric, value):
    cell = harness.Cell(root, "organelles.store")
    got = cell.reader(metric).read(ctx)
    assert got == (None if value is None else pytest.approx(value))


def test_the_tracers_records_are_read(monkeypatch):
    from syconn_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "records", lambda: list(RECORDS))
    assert program_spans.program_records() == RECORDS
