"""Device time of the head after the U-Net engine (crop, softmax, quantise or threshold and pack; engine.head spans' CUDA events) per tile, in ms."""

from perfbench.lib import program_spans


def read(ctx):
    return program_spans.device_ms_per_tile(ctx, ("engine.head",))
