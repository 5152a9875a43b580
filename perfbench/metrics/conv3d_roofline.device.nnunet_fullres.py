"""The conv kernels' share of their roofline in the nnU-Net cell: the bound of every conv launch of the stretch (the family's plan: 22 convs and 5 k2 transposes a forward) over the kernels' device time, in %."""

from perfbench.lib import readers


def read(ctx):
    return readers.conv_roofline(ctx)
