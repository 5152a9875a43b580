"""Device time of the resident predictor's copies (window stacking, output concatenation, class reassembly; resident.stack, resident.concat, resident.reassembly spans' CUDA events) per tile, in ms."""

from perfbench.lib import program_spans

SPANS = ("resident.stack", "resident.concat", "resident.reassembly")


def read(ctx):
    return program_spans.device_ms_per_tile(ctx, SPANS)
