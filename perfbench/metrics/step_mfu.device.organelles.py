"""The whole step's share of the cards' bf16 peak over the traced run's untraced passes: frozen U-Net FLOPs of their tiles over their time, in %. It rescales the window's rate by a constant of the configuration."""

from perfbench.lib import readers


def read(ctx):
    return readers.step_mfu(ctx)
