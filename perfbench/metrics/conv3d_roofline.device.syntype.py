"""The conv kernels' share of their roofline: the frozen bound of every conv launch in the stretch over the kernels' device time, in %."""

from perfbench.lib import readers


def read(ctx):
    return readers.conv_roofline(ctx)
