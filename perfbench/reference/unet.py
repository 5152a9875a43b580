"""Plain PyTorch forward of the patchified 3D U-Net, written from the
architecture in a configuration file.

Flax semantics, channels first internally (``N, C, X, Y, Z``):

* input voxels v (uint8 range) -> v / 127.5 - 1, folded space-to-depth by
  ``patch`` (channel index (ix * py + iy) * pz + iz);
* per level a ConvBlock: twice a 3x3x3 SAME conv + bias, LayerNorm over the
  channels (eps 1e-6, var = E[x^2] - mean^2), tanh-GELU;
* between levels a 3x3x3 conv with the level's stride, SAME padding
  (``lo = total // 2``) + bias;
* up the decoder a flax ``ConvTranspose`` (SAME, kernel not flipped: the
  input dilated by the stride, padded as ``lax.conv_transpose`` pads,
  correlated with the kernel) + bias, concatenated before the skip;
* a 1x1x1 head to ``n_classes * prod(patch)`` logits grouped (class, patch
  voxel).

``precision="f32"`` is the reference: float32 throughout, TF32 off.
``precision="fp8"`` is the control: every conv's operands and the head's
input rounded to float8 e4m3 with a per-tensor scale (the step below the
configuration's bf16), accumulation, LayerNorm, GELU and the head's weights
in float32.

Weights are a flax-layout tree of tensors: ``ConvBlock_i/Conv_j/{kernel,
bias}`` (kernel (3, 3, 3, Cin, Cout)), ``ConvBlock_i/LayerNorm_j/{scale,
bias}``, ``Conv_i`` (stride convs), ``ConvTranspose_k`` (k = 0 deepest) and
``head`` (kernel (1, 1, 1, Cin, Nh)).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def set_precision() -> None:
    """Float32 products and sums: TF32 off for cuDNN and matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def quantize(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return x
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    scale = FP8_MAX / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def _same_pads(n: int, s: int, k: int = 3):
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _transpose_pads(s: int, k: int = 3):
    pad_len = k + s - 2
    lo = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    return lo, pad_len - lo


def _fpad(pads):
    """Per-axis (lo, hi) in (X, Y, Z) order -> F.pad's list."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def _conv(h, p, stride, precision):
    w = p["kernel"].float().permute(4, 3, 0, 1, 2)
    pads = [_same_pads(int(n), int(s)) for n, s in zip(h.shape[2:], stride)]
    y = F.conv3d(F.pad(quantize(h, precision), _fpad(pads)), quantize(w, precision),
                 stride=tuple(int(s) for s in stride))
    return y + p["bias"].float().view(1, -1, 1, 1, 1)


def _conv_transpose(h, p, stride, precision):
    b, c, X, Y, Z = h.shape
    sx, sy, sz = (int(s) for s in stride)
    d = h.new_zeros((b, c, (X - 1) * sx + 1, (Y - 1) * sy + 1, (Z - 1) * sz + 1))
    d[:, :, ::sx, ::sy, ::sz] = h
    pads = [_transpose_pads(s) for s in (sx, sy, sz)]
    w = p["kernel"].float().permute(4, 3, 0, 1, 2)
    y = F.conv3d(F.pad(quantize(d, precision), _fpad(pads)), quantize(w, precision))
    return y + p["bias"].float().view(1, -1, 1, 1, 1)


def _layer_norm(h, p):
    mu = h.mean(1, keepdim=True)
    var = torch.clamp((h * h).mean(1, keepdim=True) - mu * mu, min=0.0)
    y = (h - mu) * torch.rsqrt(var + 1e-6)
    return y * p["scale"].float().view(1, -1, 1, 1, 1) + p["bias"].float().view(1, -1, 1, 1, 1)


def _gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _block(h, p, precision):
    for j in range(2):
        h = _conv(h, p[f"Conv_{j}"], (1, 1, 1), precision)
        h = _gelu(_layer_norm(h, p[f"LayerNorm_{j}"]))
    return h


def space_to_depth(v: torch.Tensor, patch: Sequence[int]) -> torch.Tensor:
    """(X, Y, Z) -> (px * py * pz, X / px, Y / py, Z / pz)."""
    px, py, pz = (int(p) for p in patch)
    X, Y, Z = v.shape
    v = v.reshape(X // px, px, Y // py, py, Z // pz, pz).permute(1, 3, 5, 0, 2, 4)
    return v.reshape(px * py * pz, X // px, Y // py, Z // pz)


def logits_packed(arch: dict, params: dict, window: torch.Tensor,
                  precision: str = "f32") -> torch.Tensor:
    """window (X, Y, Z) uint8 -> logits (n_classes * pvox, X/px, Y/py, Z/pz)
    in float32."""
    feats = [int(f) for f in arch["features"]]
    strides = [tuple(int(s) for s in st) for st in arch["strides"]]
    depth = len(feats)
    h = space_to_depth(window.float() / 127.5 - 1.0, arch["patch"])[None]
    skips = []
    for i in range(depth):
        h = _block(h, params[f"ConvBlock_{i}"], precision)
        if i < depth - 1:
            skips.append(h)
            h = _conv(h, params[f"Conv_{i}"], strides[i], precision)
    for k, i in enumerate(reversed(range(depth - 1))):
        h = _conv_transpose(h, params[f"ConvTranspose_{k}"], strides[i], precision)
        h = torch.cat([h, skips[i]], dim=1)
        h = _block(h, params[f"ConvBlock_{depth + k}"], precision)
    hw = params["head"]["kernel"].float().reshape(feats[0], -1)
    y = torch.einsum("bcxyz,cn->bnxyz", quantize(h, precision), hw)
    return (y + params["head"]["bias"].float().view(1, -1, 1, 1, 1))[0]


def probs_u8(arch: dict, logits: torch.Tensor) -> torch.Tensor:
    """Packed logits (C * pvox, sx, sy, sz) -> full-resolution uint8
    probabilities (C, sx * px, sy * py, sz * pz): softmax over the classes,
    x 255, rounded to nearest (ties to even)."""
    px, py, pz = (int(p) for p in arch["patch"])
    C = int(arch["n_classes"])
    _, sx, sy, sz = logits.shape
    p = torch.softmax(logits.reshape(C, px * py * pz, sx, sy, sz), dim=0)
    q = torch.round(p * 255.0).to(torch.uint8)
    q = q.reshape(C, px, py, pz, sx, sy, sz).permute(0, 4, 1, 5, 2, 6, 3)
    return q.reshape(C, sx * px, sy * py, sz * pz)
