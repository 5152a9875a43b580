"""Host seconds waiting for the per-chunk lock before a chunk write (chunk.lock_wait spans), summed over threads, per GVx."""

from perfbench.lib import program_spans


def read(ctx):
    return program_spans.thread_s_per_gvx(ctx, "chunk.lock_wait")
