"""Patchified 3D U-Net for dense voxel predictions (counterpart of
``syconn_tpu/models/unet3d.py``).

:class:`UNet3D` is the plain PyTorch module with flax semantics: the
reference that the engine (``unet_engine.py``) is held against. Layout and
dtypes follow the JAX package: channels-last ``(B, X, Y, Z, C)``, bf16
activations, f32 parameters and logits. Convolutions compute in f32 on
bf16-rounded operands and round their output to bf16 before the bf16 bias
add; the ConvBlock does LayerNorm in f32, casts to bf16 and then applies
tanh-GELU in bf16, as the flax ``ConvBlock`` does (``unet3d.py:64-65``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["UNet3D", "ConvBlock", "unet_variants", "space_to_depth", "depth_to_space"]

_BF16 = torch.bfloat16


def space_to_depth(x: torch.Tensor, p: Tuple[int, int, int]) -> torch.Tensor:
    """(B, X, Y, Z, C) -> (B, X/px, Y/py, Z/pz, C*px*py*pz)."""
    b, sx, sy, sz, c = x.shape
    x = x.reshape(b, sx // p[0], p[0], sy // p[1], p[1], sz // p[2], p[2], c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, sx // p[0], sy // p[1], sz // p[2], p[0] * p[1] * p[2] * c)


def depth_to_space(x: torch.Tensor, p: Tuple[int, int, int]) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    b, sx, sy, sz, c = x.shape
    cc = c // (p[0] * p[1] * p[2])
    x = x.reshape(b, sx, sy, sz, p[0], p[1], p[2], cc)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, sx * p[0], sy * p[1], sz * p[2], cc)


def same_pads(extents, strides, k: int = 3):
    """XLA SAME padding ((lo, hi) per axis) of a k-wide strided conv."""
    pads = []
    for n, s in zip(extents, strides):
        out = -(-int(n) // int(s))
        total = max((out - 1) * int(s) + k - int(n), 0)
        pads.append((total // 2, total - total // 2))
    return pads


def transpose_pads(strides, k: int = 3):
    """``lax.conv_transpose`` SAME padding of the dilated input per axis."""
    pads = []
    for s in strides:
        n = k + int(s) - 2
        lo = k - 1 if int(s) > k - 1 else int(math.ceil(n / 2))
        pads.append((lo, n - lo))
    return pads


class Conv3d(nn.Module):
    """flax ``nn.Conv``/``nn.ConvTranspose`` (SAME) with a bf16 compute
    dtype; ``weight`` is OIDHW f32."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride=(1, 1, 1),
                 transpose: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride = tuple(int(s) for s in stride)
        self.transpose = transpose

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(_BF16).float().permute(0, 4, 1, 2, 3)
        w = self.weight.to(_BF16).float()
        if self.transpose:
            b, c, X, Y, Z = xf.shape
            sx, sy, sz = self.stride
            xd = xf.new_zeros((b, c, (X - 1) * sx + 1, (Y - 1) * sy + 1, (Z - 1) * sz + 1))
            xd[:, :, ::sx, ::sy, ::sz] = xf
            pads = transpose_pads(self.stride)
            y = F.conv3d(F.pad(xd, _torch_pads(pads)), w)
        else:
            pads = same_pads(xf.shape[2:], self.stride, self.weight.shape[-1])
            y = F.conv3d(F.pad(xf, _torch_pads(pads)), w, stride=self.stride)
        return y.permute(0, 2, 3, 4, 1).to(_BF16) + self.bias.to(_BF16)


def _torch_pads(pads):
    """Per-axis (lo, hi) in (X, Y, Z) order -> F.pad's last-axis-first list."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: eps 1e-6, var = E[x^2] - mu^2."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        mu = h.mean(-1, keepdim=True)
        var = torch.clamp((h * h).mean(-1, keepdim=True) - mu * mu, min=0.0)
        return (h - mu) * (torch.rsqrt(var + 1e-6) * self.scale) + self.bias


class ConvBlock(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.Conv_0 = Conv3d(cin, features)
        self.LayerNorm_0 = LayerNorm(features)
        self.Conv_1 = Conv3d(features, features)
        self.LayerNorm_1 = LayerNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            x = getattr(self, f"Conv_{i}")(x)
            x = getattr(self, f"LayerNorm_{i}")(x).to(_BF16)
            x = F.gelu(x, approximate="tanh")
        return x


class UNet3D(nn.Module):
    """Patchified encoder-decoder with skip connections; submodules carry
    the flax names so flax parameter trees map onto them one to one.

    Args:
        features: channel widths per level (len = depth).
        strides: downsampling factors between levels (len = depth - 1).
        patch: space-to-depth folding of the input.
        n_classes: output channels.

    Kernels start lecun-normal from a fixed seed; real weights come from
    ``models.io.load_model``.
    """

    def __init__(self, features: Sequence[int] = (64, 128, 256),
                 strides: Sequence[Tuple[int, int, int]] = ((2, 2, 2), (2, 2, 2)),
                 patch: Tuple[int, int, int] = (4, 4, 2), n_classes: int = 2):
        super().__init__()
        self.features = tuple(int(f) for f in features)
        self.strides = tuple(tuple(int(s) for s in st) for st in strides)
        self.patch = tuple(int(p) for p in patch)
        self.n_classes = int(n_classes)
        depth = len(self.features)
        pvox = int(np.prod(self.patch))
        cin = pvox
        for i, f in enumerate(self.features):
            self.add_module(f"ConvBlock_{i}", ConvBlock(cin, f))
            if i < depth - 1:
                nxt = self.features[i + 1]
                self.add_module(f"Conv_{i}", Conv3d(f, nxt, stride=self.strides[i]))
                cin = nxt
        for k, i in enumerate(reversed(range(depth - 1))):
            f = self.features[i]
            self.add_module(f"ConvTranspose_{k}", Conv3d(
                self.features[i + 1], f, stride=self.strides[i], transpose=True))
            self.add_module(f"ConvBlock_{depth + k}", ConvBlock(2 * f, f))
        self.head = Conv3d(self.features[0], self.n_classes * pvox, kernel=1)
        gen = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, Conv3d):
                fan_in = m.weight[0].numel()
                with torch.no_grad():
                    m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)

    def forward(self, x: torch.Tensor, full_res: bool = True) -> torch.Tensor:
        """x: (B, X, Y, Z, 1) raw voxels (uint8 value range). Returns
        full-resolution logits (B, X, Y, Z, n_classes), or with
        ``full_res=False`` the patched logits (B, X/px, Y/py, Z/pz,
        n_classes * pvox) grouped as (class, patch_voxel)."""
        depth = len(self.features)
        h = (x.float() / 127.5 - 1.0).to(_BF16)
        h = space_to_depth(h, self.patch)
        skips = []
        for i in range(depth):
            h = getattr(self, f"ConvBlock_{i}")(h)
            if i < depth - 1:
                skips.append(h)
                h = getattr(self, f"Conv_{i}")(h)
        for k, i in enumerate(reversed(range(depth - 1))):
            h = getattr(self, f"ConvTranspose_{k}")(h)
            h = torch.cat([h, skips[i]], dim=-1)
            h = getattr(self, f"ConvBlock_{depth + k}")(h)
        hw = self.head.weight.reshape(self.head.weight.shape[0], -1).t().float()
        head = h.float() @ hw + self.head.bias.float()
        if not full_res:
            return head
        return packed_to_full(head, self.n_classes, self.patch)


def packed_to_full(head: torch.Tensor, n_classes: int, patch) -> torch.Tensor:
    """Patched logits (..., n_classes * pvox) -> full resolution."""
    b, sx, sy, sz, _ = head.shape
    pvox = int(np.prod(patch))
    lg = head.reshape(b, sx, sy, sz, n_classes, pvox).movedim(-2, -1)
    return depth_to_space(lg.reshape(b, sx, sy, sz, -1), tuple(patch))


def unet_variants(name: str) -> dict:
    """Architecture presets per dense-prediction task."""
    presets = {
        "myelin": dict(features=(64, 128), strides=((2, 2, 2),), patch=(4, 4, 2), n_classes=2),
        "syntype": dict(features=(64, 128, 256), strides=((2, 2, 2), (2, 2, 2)), patch=(4, 4, 2), n_classes=3),
        "organelles": dict(features=(64, 128, 256), strides=((2, 2, 2), (2, 2, 2)), patch=(4, 4, 2), n_classes=4),
        "er": dict(features=(64, 128), strides=((2, 2, 2),), patch=(4, 4, 2), n_classes=2),
        "golgi": dict(features=(64, 128), strides=((2, 2, 2),), patch=(4, 4, 2), n_classes=2),
    }
    if name not in presets:
        raise KeyError(f"Unknown UNet variant '{name}'. Available: {sorted(presets)}")
    return presets[name]
