"""Host seconds in ChunkedVolume.load_raw, summed over threads, per GVx."""

from perfbench.lib import readers


def read(ctx):
    return readers.thread_s_per_gvx(ctx, "load_raw")
