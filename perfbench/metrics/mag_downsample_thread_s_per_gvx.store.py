"""Host seconds pooling each written region to the mags above 1 (chunk.downsample spans), summed over threads, per GVx."""

from perfbench.lib import program_spans


def read(ctx):
    return program_spans.thread_s_per_gvx(ctx, "chunk.downsample")
