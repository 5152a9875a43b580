"""Host seconds in the chunk store's compression (the program's chunk.compress spans), summed over threads, per GVx."""

from perfbench.lib import program_spans


def read(ctx):
    return program_spans.thread_s_per_gvx(ctx, "chunk.compress")
