"""Host seconds copying partial chunk writes into the chunks being assembled in memory (chunk.stage spans), summed over threads, per GVx."""

from perfbench.lib import program_spans


def read(ctx):
    return program_spans.thread_s_per_gvx(ctx, "chunk.stage")
