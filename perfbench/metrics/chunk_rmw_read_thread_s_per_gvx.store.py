"""Host seconds reading back the chunks a partial write modifies (cache, file, decompress, copy; chunk.rmw_read spans), summed over threads, per GVx."""

from perfbench.lib import program_spans


def read(ctx):
    return program_spans.thread_s_per_gvx(ctx, "chunk.rmw_read")
