"""The ``unet3d`` family's reference forward: one window through the plain
U-Net of :mod:`perfbench.reference.unet` to its class probabilities."""

from __future__ import annotations

import torch

from . import unet


def forward(arch: dict, params: dict, window: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """window (X, Y, Z) uint8 -> uint8 probabilities (C, X, Y, Z)."""
    return unet.probs_u8(arch, unet.logits_packed(arch, params, window, precision))
