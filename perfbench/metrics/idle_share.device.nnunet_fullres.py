"""Idle share of the card in the traced stretch of the nnU-Net cell, in %."""

from perfbench.lib import readers


def read(ctx):
    return readers.idle_share(ctx)
