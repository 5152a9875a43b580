"""Host seconds in DenseTilePredictor.unpack, summed over threads, per GVx."""

from perfbench.lib import readers


def read(ctx):
    return readers.thread_s_per_gvx(ctx, "unpack")
