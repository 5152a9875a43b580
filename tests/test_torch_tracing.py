"""The port's span tracer (``utils/tracing.py``) and the spans of step 1 on
the CPU: nothing recorded, no ``record_function`` and no CUDA event without
a profiler; every span with its parent, thread and call under one; each
span's start on the profiler's clock; the buffer's cap."""

import json
import threading

import numpy as np
import pytest
import torch

from syconn_tpu_torch.inference import dense
from syconn_tpu_torch.io import resident
from syconn_tpu_torch.io.chunked import ChunkedVolume
from syconn_tpu_torch.models.io import init_model_params
from syconn_tpu_torch.models.unet3d import UNet3D
from syconn_tpu_torch.utils import tracing

SPANS = {
    "dense.predict": {"route"}, "dense.unpack": set(), "engine.forward": {"batch"},
    "engine.head": {"batch", "fused_tiles"}, "predictor.build": {"replicas"}, "resident.predict": {"tiles"},
    "resident.stack": {"tiles"}, "resident.concat": {"tiles"}, "resident.reassembly": {"channel"},
    "chunk.load": {"mag"}, "chunk.save": {"mags"}, "chunk.downsample": {"mag", "mode", "voxels"},
    "chunk.lock_wait": set(), "chunk.rmw_read": set(),
    "chunk.write": {"key", "rmw", "pieces", "early"}, "chunk.compress": set(),
    "chunk.stage": set(), "dense.pool": {"tiles", "voxels"},
}
SHAPE = (64, 64, 32)  # 2 x 2 x 2 tiles of (32, 32, 16); one mag-2 chunk a map


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def clean(monkeypatch):
    monkeypatch.delenv("SYCONN_TORCH_RESIDENT_TILE_BATCH", raising=False)
    tracing.clear()
    resident.clear()
    yield
    tracing.clear()
    resident.clear()


def _run(tmp_path, tag, on_resident=False, io_threads=3, src_chunk=(32, 32, 16)):
    """Step 1 on a small chunk store: the streaming route, or with the
    source held in ``io.resident`` the resident route."""
    model = UNet3D(features=(8, 16), strides=((2, 2, 2),), patch=(2, 2, 2), n_classes=4)
    params = init_model_params(model, 0)
    vol = np.random.default_rng(0).integers(0, 255, SHAPE, dtype=np.uint8)
    src = str(tmp_path / f"raw_{tag}")
    ChunkedVolume.create(src, scale=(10, 10, 20), boundary=SHAPE,
                         chunk_shape=src_chunk).save_raw(vol)
    if on_resident:
        assert resident.put(src, "raw", vol, device="cpu")
    return dense.predict_dense_to_kd(
        src, {n: str(tmp_path / f"{n}_{tag}") for n in ("mi", "vc")}, model, params,
        {"mi": 1, "vc": 2}, tile_shape=(32, 32, 16), halo=(8, 8, 4), show_progress=False,
        device="cpu", io_threads=io_threads)


def test_no_profiler_records_nothing(tmp_path, clean, monkeypatch):
    counts = {"record_function": 0, "event": 0}
    real_rf = torch.profiler.record_function

    class CountingRecordFunction(real_rf):
        def __init__(self, *a, **kw):
            counts["record_function"] += 1
            super().__init__(*a, **kw)

    class CountingEvent:
        def __init__(self, *a, **kw):
            counts["event"] += 1

    monkeypatch.setattr(torch.profiler, "record_function", CountingRecordFunction)
    monkeypatch.setattr(torch.cuda, "Event", CountingEvent)
    spans = []
    real_span = tracing._Span
    monkeypatch.setattr(tracing, "_Span", lambda *a: spans.append(a) or real_span(*a))
    assert _run(tmp_path, "s")["route"] == "stream"
    assert _run(tmp_path, "r", on_resident=True)["route"] == "resident"
    assert tracing.records() == [] and spans == []
    assert counts == {"record_function": 0, "event": 0}
    fn = tracing.carry(_run)
    assert fn is _run


def test_spans_with_parent_thread_and_call(tmp_path, clean):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _run(tmp_path, "s")
        _run(tmp_path, "r", on_resident=True)
    recs = tracing.records()
    by_id = {r["id"]: r for r in recs}
    assert set(SPANS) <= {r["name"] for r in recs}
    for r in recs:
        if r["name"] in SPANS:
            assert set(r["attrs"]) == SPANS[r["name"]], r
        assert r["t0"] <= r["t1"] and r["device_s"] is None
    roots = [r for r in recs if r["parent"] is None]
    # the two calls, and the source stores written before each
    calls = [r for r in roots if r["name"] == "dense.predict"]
    assert [c["attrs"]["route"] for c in calls] == ["stream", "resident"]
    assert {r["name"] for r in roots} == {"dense.predict", "chunk.save"}
    for r in recs:
        # every span is in its root's call, and its parent's
        root = r
        while root["parent"] is not None:
            parent = by_id[root["parent"]]
            assert parent["call"] == root["call"] and parent["t0"] <= root["t0"]
            root = parent
        assert r["call"] == root["id"]
    main = threading.get_native_id()
    call_ids = {c["id"] for c in calls}
    in_calls = [r for r in recs if r["call"] in call_ids]
    workers = [r for r in in_calls if r["thread"] != main]
    assert {"chunk.load", "chunk.save", "chunk.write", "chunk.compress",
            "dense.unpack"} <= {r["name"] for r in workers}
    for r in recs:
        if r["name"] == "chunk.compress":
            write = by_id[r["parent"]]
            assert write["name"] == "chunk.write"
            assert by_id[write["parent"]]["name"] == "chunk.save"
    # 2 maps x (8 mag-1 chunks + 1 mag-2 chunk assembled from 8 pieces), each
    # written once, a call
    for c in calls:
        writes = [r for r in recs if r["name"] == "chunk.write" and r["call"] == c["id"]]
        assert len(writes) == 18 and len({w["attrs"]["key"] for w in writes}) == 18
        assert sum(w["attrs"]["rmw"] for w in writes) == 2
        assert sorted(w["attrs"]["pieces"] for w in writes) == [1] * 16 + [8] * 2
        assert not any(w["attrs"]["early"] for w in writes)
    assert next(r for r in recs if r["name"] == "resident.predict")["attrs"]["tiles"] == 8
    # the CPU runs the plain head: no tile through the head kernel
    heads = [r for r in recs if r["name"] == "engine.head"]
    assert heads and all(r["attrs"]["fused_tiles"] == 0 for r in heads)


def test_span_starts_on_the_profilers_clock(tmp_path, clean):
    """After one offset, taken from the first span, each span's interval
    holds its annotation's on the chrome trace's clock, and the starts
    agree within 0.5 ms. The span reads its clock just before the annotation
    opens and just after it closes, so the holding is causal; a start and
    its annotation are two readings microseconds apart that a thread
    preempted between them (the suite shares the CPU) separates by
    milliseconds, so a few starts may disagree."""
    trace = tmp_path / "trace.json"
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                experimental_config=config) as prof:
        # one source chunk: loads need no chunk pool, whose sixteen threads
        # would each pay the profiler's registration at their first span
        _run(tmp_path, "s", io_threads=2, src_chunk=SHAPE)
    prof.export_chrome_trace(str(trace))
    recs = sorted(tracing.records(), key=lambda r: r["t0"])
    events = json.loads(trace.read_text())["traceEvents"]
    ann = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"] in SPANS:
            ts = float(e["ts"])
            ann.setdefault((e["name"], int(e["tid"])), []).append((ts, ts + float(e["dur"])))
    mine = {}
    for r in recs:
        mine.setdefault((r["name"], r["thread"]), []).append((r["t0"] / 1e3, r["t1"] / 1e3))
    assert set(ann) == set(mine)
    first = recs[0]
    offset = ann[(first["name"], first["thread"])][0][0] - first["t0"] / 1e3
    starts = []
    for key, spans in mine.items():
        assert len(ann[key]) == len(spans), key
        for (a0, a1), (t0, t1) in zip(sorted(ann[key]), spans):
            assert t0 + offset - 500.0 <= a0 and a1 <= t1 + offset + 500.0, (key, a0 - t0 - offset)
            starts.append(abs(a0 - t0 - offset))
    assert len(starts) == len(recs) > 100
    assert sum(d <= 500.0 for d in starts) >= 0.95 * len(starts), sorted(starts)[-10:]


def test_buffer_cap_drops_and_counts(clean, monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(5):
            with tracing.span("s", i=i):
                pass
    assert [r["attrs"]["i"] for r in tracing.records()] == [0, 1, 2]
    assert tracing.dropped() == 2
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped() == 0
