"""Arithmetic of the per-layer readers of the program's own spans
(``syconn_tpu_torch/utils/tracing.py``), which record while the traced
stretch's profiler runs. Each function returns None without a device trace,
without the tracer (a program older than it) or without the span."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .readers import stretch_tiles


def program_records() -> Optional[List[Dict]]:
    """The program's span records, or None where it has no tracer."""
    try:
        from syconn_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.records()


def in_stretch(ctx) -> Optional[List[Dict]]:
    """The records that begin and end inside the traced stretch, placed on
    the trace's clock through its host anchor."""
    t = ctx.trace_data
    if t is None:
        return None
    recs = program_records()
    if recs is None:
        return None
    return [r for r in recs if t.start <= t.host_us(r["t0"]) and t.host_us(r["t1"]) <= t.end]


def _named(ctx, names: Sequence[str]) -> Optional[List[Dict]]:
    recs = in_stretch(ctx)
    if recs is None:
        return None
    out = [r for r in recs if r["name"] in names]
    return out or None


def thread_s_per_gvx(ctx, name: str) -> Optional[float]:
    """Seconds of ``name``'s spans summed over threads, per GVx of the
    stretch's passes."""
    recs = _named(ctx, (name,))
    if recs is None or not ctx.stretch_passes:
        return None
    gvx = ctx.stretch_passes * ctx.voxels_per_pass / 1e9
    return sum(r["t1"] - r["t0"] for r in recs) / 1e9 / gvx


def writes_per_chunk(ctx) -> Optional[float]:
    """``chunk.write`` spans over the distinct chunks (``key``) they wrote."""
    recs = _named(ctx, ("chunk.write",))
    if recs is None:
        return None
    return len(recs) / len({r["attrs"]["key"] for r in recs})


def device_ms_per_tile(ctx, names: Sequence[str]) -> Optional[float]:
    """Device time of the spans named ``names`` (their CUDA event pairs),
    per tile of the stretch, in ms."""
    recs = _named(ctx, names)
    if recs is None or not stretch_tiles(ctx):
        return None
    times = [r["device_s"] for r in recs]
    if any(s is None for s in times):
        return None
    return 1e3 * sum(times) / stretch_tiles(ctx)
