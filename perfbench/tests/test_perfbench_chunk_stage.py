"""The reader of the chunk store's staging copies (``chunk.stage``) on
synthetic records: the sum over threads per GVx of the stretch, and None
from a program that stages nothing."""

import pytest

from perfbench.lib import harness, program_spans
from perfbench.lib import trace as tr


class _Ctx:
    """A stretch of 2 passes of 0.5 GVx each, on a trace whose [0, 100] us
    is host [1_000_000, 1_100_000] ns."""

    def __init__(self):
        self.trace_data = tr.Trace([], 0.0, 100.0, host_anchor_ns=1_000_000)
        self.stretch_passes, self.tiles_per_pass = 2, 4
        self.voxels_per_pass = 5 * 10 ** 8


def _rec(name, t0, t1, thread=1, **attrs):
    return dict(name=name, t0=1_000_000 + t0, t1=1_000_000 + t1, thread=thread, id=0,
                parent=None, call=0, attrs=attrs, device_s=None)


RECORDS = [
    _rec("chunk.stage", 1_000, 4_000, thread=1),
    _rec("chunk.stage", 2_000, 7_000, thread=2),  # overlaps in time: threads add up
    _rec("chunk.write", 8_000, 20_000, key="/mi/raw/mag2/c_0_0_0.zst", rmw=True, pieces=8,
         early=False),
    _rec("chunk.stage", -3_000, 1_000),  # straddles the stretch's start
    _rec("chunk.stage", 150_000, 160_000),  # after it
]


@pytest.mark.parametrize("records,value", [
    (RECORDS, 8e-6),  # 8 us over 2 passes x 0.5 GVx
    ([r for r in RECORDS if r["name"] != "chunk.stage"], None),  # a program that stages nothing
    (None, None),  # a program older than the tracer
])
def test_chunk_stage_reader(root, monkeypatch, records, value):
    monkeypatch.setattr(program_spans, "program_records",
                        lambda: None if records is None else [dict(r) for r in records])
    got = harness.Cell(root, "organelles.store").reader(
        "chunk_stage_thread_s_per_gvx.store").read(_Ctx())
    assert got == (None if value is None else pytest.approx(value))
