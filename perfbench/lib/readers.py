"""Arithmetic the per-layer metric readers share. Each reader returns None
when the run gave it nothing to read (no trace, no span, a launch count
that does not match the frozen plan)."""

from __future__ import annotations

from typing import List, Optional

from . import frozen
from . import trace as tr
from .spans import thread_seconds


def device_trace(ctx) -> Optional[tr.Trace]:
    """The stretch's device trace where it kept the card's clock, else
    None: a trace that did not reads every device time short."""
    t = ctx.trace_data
    return t if t is not None and t.complete else None


def forwards(ctx) -> List[int]:
    """Batch size of every engine forward in the traced stretch."""
    return [s["batch"] for s in ctx.stretch_spans if s["name"] == "forward_on"]


def stretch_tiles(ctx) -> int:
    return ctx.stretch_passes * ctx.tiles_per_pass


def conv_roofline(ctx) -> Optional[float]:
    """Sum over the stretch's conv launches of each launch's bound, over the
    device time of the conv kernels, in %."""
    t = device_trace(ctx)
    fw = forwards(ctx)
    if t is None or not fw:
        return None
    win = ctx.window_shape
    launches = [ctx.family.conv_launches(ctx.arch, [b] + win) for b in fw]
    convs = tr.matching(t, ctx.family.CONV_KERNELS)
    if len(convs) != sum(len(x) for x in launches):
        return None
    bound = sum(frozen.launch_bound_s(x) for ls in launches for x in ls)
    busy = sum(e["dur"] for e in convs) / 1e6
    return 100.0 * bound / busy if busy > 0 else None


def other_ms_per_tile(ctx) -> Optional[float]:
    """Device time of everything but the conv kernels, per tile of the
    configuration, in ms."""
    t = device_trace(ctx)
    if t is None or not stretch_tiles(ctx):
        return None
    conv = {id(e) for e in tr.matching(t, ctx.family.CONV_KERNELS)}
    other = sum(e["dur"] for e in t.events if id(e) not in conv)
    return other / 1e3 / stretch_tiles(ctx)


def step_mfu(ctx) -> Optional[float]:
    """The configuration's forward FLOPs (its family's count) at the
    tile-plus-halo input, times its tiles per pass, over the time of the
    window's untraced passes and the peak of the cell's cards, in %. The
    passes of every traced stretch, which carry the profiler's cost, are
    left out."""
    if ctx.device.type != "cuda":
        return None
    traced = set(ctx.traced_passes)
    untraced = [s for i, s in enumerate(ctx.pass_seconds) if i not in traced]
    if not untraced or sum(untraced) <= 0:
        return None
    flops = ctx.family.flops(ctx.arch, [1] + ctx.window_shape) * ctx.tiles_per_pass
    return 100.0 * flops * len(untraced) / sum(untraced) / (frozen.PEAK_FLOPS * ctx.n_cards)


def idle_share(ctx) -> Optional[float]:
    t = device_trace(ctx)
    if t is None:
        return None
    return tr.idle_share(t, ctx.card_indices)


def thread_s_per_gvx(ctx, span: str) -> Optional[float]:
    """Seconds of ``span`` summed over threads per GVx of the stretch."""
    if not ctx.stretch_passes or not any(s["name"] == span for s in ctx.stretch_spans):
        return None
    gvx = ctx.stretch_passes * ctx.voxels_per_pass / 1e9
    return thread_seconds(ctx.stretch_spans, span) / gvx
