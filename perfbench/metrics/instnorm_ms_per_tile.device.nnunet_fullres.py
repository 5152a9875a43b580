"""Device time of the instance norms (engine.norm spans' CUDA events, one span a norm) per tile, in ms."""

from perfbench.lib import program_spans


def read(ctx):
    return program_spans.device_ms_per_tile(ctx, ("engine.norm",))
