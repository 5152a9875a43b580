"""The whole step's share of the card's bf16 peak over the traced run's untraced passes: the family's nnU-Net FLOPs of their tiles' 128^3 windows over their time, in %."""

from perfbench.lib import readers


def read(ctx):
    return readers.step_mfu(ctx)
