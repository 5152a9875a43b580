"""Device time of everything but the conv kernels (tile cut, patchify, softmax, quantise, pack, class reassembly) per tile, in ms."""

from perfbench.lib import readers


def read(ctx):
    return readers.other_ms_per_tile(ctx)
