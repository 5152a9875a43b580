"""Host seconds in ChunkedVolume.save_raw (mag 1 and 2, codec, downsample), summed over threads, per GVx."""

from perfbench.lib import readers


def read(ctx):
    return readers.thread_s_per_gvx(ctx, "save_raw")
