"""The instance norms' share of their roofline: the bytes that bound every norm of the stretch (the family's norm_layers: a read of the bf16 conv output, a write of the bf16 activation, the parameters) over HBM's peak, over the device time of the norm kernels, in %. None unless the program recorded one engine.norm span for each of the family's norms of each forward."""

from perfbench.lib import frozen, program_spans, readers
from perfbench.lib import trace as tr


def read(ctx):
    t = readers.device_trace(ctx)
    fw = readers.forwards(ctx)
    recs = program_spans.in_stretch(ctx)
    if t is None or not fw or recs is None:
        return None
    win = ctx.window_shape
    layers = [x for b in fw for x in ctx.family.norm_layers(ctx.arch, [b] + win)]
    if sum(1 for r in recs if r["name"] == "engine.norm") != len(layers):
        return None
    busy = sum(e["dur"] for e in tr.matching(t, ctx.family.NORM_KERNELS)) / 1e6
    bound = sum(x["bytes"] for x in layers) / frozen.PEAK_BYTES
    return 100.0 * bound / busy if busy > 0 else None
