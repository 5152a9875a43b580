"""Inference engine for :class:`UNet3D` on the hand-written conv kernels
(counterpart of ``syconn_tpu/models/unet_engine.py``).

Replays the module graph of ``UNet3D.forward`` from the engine parameters
(:func:`..models.convert.params_from_flax`) and runs every 3x3x3 conv
through ``ops/conv3d.py``: on CUDA tensors the kernels, on CPU tensors
their plain versions. The op order per layer is the Pallas engine's — GELU
in f32 inside the fused epilogue — so the engine is held against the JAX
engine, and ``UNet3D.forward`` against flax.

The three alternatives of the JAX engine are keyword arguments with its
defaults:

* ``up_phases`` — transposes as 8 sub-pixel phases (``conv_transpose2x_bias``);
  off: the zero-stuffed grid through the SAME kernel with a bias epilogue.
* ``down_phases`` — stride-2 convs through ``conv_down2x_bias``; off: the
  SAME kernel (bias epilogue) at full resolution, then every second output.
* ``fused_head`` — the 1x1x1 head fused into the last conv's epilogue; off:
  an f32 matmul after it.

Shape rule: odd extents or strides other than 2 cannot take the phase
kernels; they run the SAME kernel on the stuffed grid / with a strided
slice, which computes the same SAME conv exactly.

Per-layer comparison (one device against another): ``trace`` collects
``(name, input, output)`` of every conv layer; ``feed`` maps a layer name to
the input that layer takes instead of its predecessor's output, so that
one layer can be run on another device's input alone.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.conv3d import (conv3x3x3_ln_gelu, conv_down2x_bias,
                          conv_transpose2x_bias, zero_stuff)
from .unet3d import UNet3D, packed_to_full, same_pads, space_to_depth

__all__ = ["engine_supported", "unet_apply_packed", "unet_apply_full", "unet_flops"]


def engine_supported(model) -> bool:
    """The engine covers the UNet3D family as built by ``unet_variants``."""
    return isinstance(model, UNet3D)


class _Steps:
    """Runs the named layers, applying ``feed`` and recording ``trace``."""

    def __init__(self, trace: Optional[List], feed: Optional[Dict[str, torch.Tensor]]):
        self.trace, self.feed = trace, feed or {}

    def __call__(self, name: str, fn, h: torch.Tensor) -> torch.Tensor:
        h = self.feed.get(name, h)
        out = fn(h)
        if self.trace is not None:
            self.trace.append((name, h, out))
        return out


def _block(p, h, step, name):
    for i in range(2):
        q = (p[f"Conv_{i}"], p[f"LayerNorm_{i}"])
        h = step(f"{name}_conv{i}", lambda t, q=q: conv3x3x3_ln_gelu(
            t, q[0]["kernel"], q[0]["bias"], q[1]["scale"], q[1]["bias"]), h)
    return h


def _down(p, h, stride, down_phases: bool):
    stride = tuple(int(s) for s in stride)
    even = all(int(s) % 2 == 0 for s in h.shape[1:4])
    if stride == (2, 2, 2) and even and down_phases:
        return conv_down2x_bias(h, p["kernel"], p["bias"])
    # SAME strided conv = SAME stride-1 conv sampled at s*o + 1 - pad_lo
    full = conv3x3x3_ln_gelu(h, p["kernel"], p["bias"], epilogue="bias")
    sl = [slice(None)]
    for n, s, (lo, _) in zip(h.shape[1:4], stride, same_pads(h.shape[1:4], stride)):
        out = -(-int(n) // s)
        start = 1 - lo
        sl.append(slice(start, start + (out - 1) * s + 1, s))
    return full[tuple(sl)].contiguous()


def _up(p, h, stride, up_phases: bool):
    stride = tuple(int(s) for s in stride)
    if stride == (2, 2, 2) and up_phases:
        return conv_transpose2x_bias(h, p["kernel"], p["bias"])
    return conv3x3x3_ln_gelu(zero_stuff(h, stride), p["kernel"], p["bias"], epilogue="bias")


def unet_apply_packed(model: UNet3D, params: dict, x: torch.Tensor,
                      up_phases: bool = True, down_phases: bool = True,
                      fused_head: bool = True, trace: Optional[List] = None,
                      feed: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """= ``model(x, full_res=False)`` on the conv kernels.

    x: (B, X, Y, Z, 1) raw voxels (uint8 value range) on the params' device.
    Returns packed f32 logits (B, X/px, Y/py, Z/pz, n_classes * pvox).
    ``trace``/``feed``: see the module docstring; layer names are
    ``enc<i>_conv<j>``, ``down<i>``, ``up<k>``, ``dec<k>_conv<j>`` and
    ``head`` (the last conv with the fused head, or the separate head)."""
    step = _Steps(trace, feed)
    feats: Tuple[int, ...] = tuple(model.features)
    depth = len(feats)
    h = (x.float() / 127.5 - 1.0).to(torch.bfloat16)
    h = space_to_depth(h, tuple(model.patch)).contiguous()
    skips = []
    for i in range(depth):
        h = _block(params[f"ConvBlock_{i}"], h, step, f"enc{i}")
        if i < depth - 1:
            skips.append(h)
            h = step(f"down{i}", lambda t, i=i: _down(params[f"Conv_{i}"], t, model.strides[i],
                                                      down_phases), h)
    hp = params["head"]
    for k, i in enumerate(reversed(range(depth - 1))):
        h = step(f"up{k}", lambda t, k=k, i=i: _up(params[f"ConvTranspose_{k}"], t,
                                                   model.strides[i], up_phases), h)
        h = torch.cat([h, skips[i]], dim=-1)
        p = params[f"ConvBlock_{depth + k}"]
        if i == 0 and fused_head:
            # last decoder block: the head runs in the second conv's epilogue
            h = step(f"dec{k}_conv0", lambda t: conv3x3x3_ln_gelu(
                t, p["Conv_0"]["kernel"], p["Conv_0"]["bias"], p["LayerNorm_0"]["scale"],
                p["LayerNorm_0"]["bias"]), h)
            return step("head", lambda t: conv3x3x3_ln_gelu(
                t, p["Conv_1"]["kernel"], p["Conv_1"]["bias"], p["LayerNorm_1"]["scale"],
                p["LayerNorm_1"]["bias"], head_w=hp["kernel"], head_b=hp["bias"]), h)
        h = _block(p, h, step, f"dec{k}")
    return step("head", lambda t: t.float() @ hp["kernel"] + hp["bias"], h)


def unet_apply_full(model: UNet3D, params: dict, x: torch.Tensor, **kw) -> torch.Tensor:
    """Full-resolution variant (``full_res=True``)."""
    head = unet_apply_packed(model, params, x, **kw)
    return packed_to_full(head, model.n_classes, model.patch)


def unet_flops(model: UNet3D, in_shape) -> float:
    """Analytic forward FLOPs for one (B, X, Y, Z) input: 2*27*S*Cin*Cout per
    3x3x3 conv, transposes counted at input (half) resolution — what the
    sub-pixel phase kernel executes — and the head at 2*S*Cin*Cout."""
    B, X, Y, Z = (int(v) for v in in_shape[:4])
    p = tuple(int(v) for v in model.patch)
    feats = tuple(int(f) for f in model.features)
    s = [X // p[0], Y // p[1], Z // p[2]]
    pvox = p[0] * p[1] * p[2]
    cin = pvox
    total = 0.0
    sizes = []
    for i, f in enumerate(feats):
        S = B * s[0] * s[1] * s[2]
        total += 2 * 27 * S * cin * f + 2 * 27 * S * f * f
        sizes.append((tuple(s), f))
        if i < len(feats) - 1:
            st = tuple(int(v) for v in model.strides[i])
            s = [s[0] // st[0], s[1] // st[1], s[2] // st[2]]
            S2 = B * s[0] * s[1] * s[2]
            total += 2 * 27 * S2 * f * feats[i + 1]
            cin = feats[i + 1]
    for i in reversed(range(len(feats) - 1)):
        up_shape, f = sizes[i]
        S = B * up_shape[0] * up_shape[1] * up_shape[2]
        sp = int(np.prod(model.strides[i]))
        total += 2 * 27 * (S // sp) * feats[i + 1] * f
        total += 2 * 27 * S * (2 * f) * f + 2 * 27 * S * f * f
    S = B * sizes[0][0][0] * sizes[0][0][1] * sizes[0][0][2]
    total += 2 * S * feats[0] * (model.n_classes * pvox)
    return float(total)
