"""Idle share of the cards in the traced stretch of a device cell, in %."""

from perfbench.lib import readers


def read(ctx):
    return readers.idle_share(ctx)
