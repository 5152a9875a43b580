"""Plain PyTorch forward of nnU-Net's 3d_fullres network (``PlainConvUNet``
of MIC-DKFZ ``dynamic_network_architectures``), written from the
architecture in a configuration file. It imports nothing of the program.

Per encoder stage s (width f_s, stride t_s): twice ``LeakyReLU(
InstanceNorm3d(Conv3d(h, k3, stride t_s then 1, padding 1) + b))``, the
result kept as the stage's skip. Up the decoder, per level from the deepest:
``ConvTranspose3d(h, k2, stride 2) + b``, concatenated before the skip, then
twice the conv-norm-LeakyReLU at the level's width. A 1x1x1 conv to the
classes is the head. InstanceNorm3d has affine parameters and ``norm_eps``;
LeakyReLU ``leaky_slope``.

Input: the uint8 window, z-scored with the configuration's
``intensity_mean`` and ``intensity_std``, zero-padded on the high side to
multiples of the product of the strides and the logits cropped back
(nnU-Net's predictor pads an image smaller than its patch so).

``precision="f32"`` is the reference: float32 throughout, TF32 off.
``precision="fp8"`` is the control: every conv's and transpose's operands and
the head's input rounded to float8 e4m3 with a per-tensor scale (the step
below the configuration's bf16), accumulation, norms and LeakyReLU in
float32.

Weights: a flat dict of tensors named as PlainConvUNet's state dict,
``encoder.stages.{s}.0.convs.{j}.{conv,norm}.{weight,bias}``,
``decoder.transpconvs.{k}.{weight,bias}``,
``decoder.stages.{k}.convs.{j}.{conv,norm}.{weight,bias}`` and the last
deep-supervision head ``decoder.seg_layers.{depth - 2}.{weight,bias}``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def quantize(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return x
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    scale = FP8_MAX / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def divisor(arch: dict) -> Tuple[int, int, int]:
    return tuple(int(np.prod([int(s[a]) for s in arch["strides"]])) for a in range(3))


def _block(h, params: Dict[str, torch.Tensor], prefix: str, stride: int, arch: dict,
           precision: str):
    for j in range(int(arch["convs_per_stage"])):
        c = f"{prefix}.convs.{j}"
        h = F.conv3d(quantize(h, precision), quantize(params[f"{c}.conv.weight"], precision),
                     params[f"{c}.conv.bias"], stride=stride if j == 0 else 1, padding=1)
        h = F.instance_norm(h, weight=params[f"{c}.norm.weight"], bias=params[f"{c}.norm.bias"],
                            eps=float(arch["norm_eps"]))
        h = F.leaky_relu(h, float(arch["leaky_slope"]))
    return h


@torch.no_grad()
def logits(arch: dict, params: Dict[str, torch.Tensor], window: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    """window (X, Y, Z) uint8 -> f32 logits (n_classes, X, Y, Z)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    feats = [int(f) for f in arch["features"]]
    strides = [int(s[0]) for s in arch["strides"]]
    depth = len(feats)
    X, Y, Z = (int(v) for v in window.shape)
    PX, PY, PZ = (-(-n // d) * d for n, d in zip((X, Y, Z), divisor(arch)))
    h = (window.float() - float(arch["intensity_mean"])) / float(arch["intensity_std"])
    h = F.pad(h, (0, PZ - Z, 0, PY - Y, 0, PX - X))[None, None]
    skips = []
    for s in range(depth):
        h = _block(h, params, f"encoder.stages.{s}.0", strides[s], arch, precision)
        skips.append(h)
    for k in range(depth - 1):
        w = params[f"decoder.transpconvs.{k}.weight"]
        h = F.conv_transpose3d(quantize(h, precision), quantize(w, precision),
                               params[f"decoder.transpconvs.{k}.bias"], stride=2)
        h = torch.cat([h, skips[depth - 2 - k]], dim=1)
        h = _block(h, params, f"decoder.stages.{k}", 1, arch, precision)
    k = depth - 2
    w = params[f"decoder.seg_layers.{k}.weight"].reshape(int(arch["n_classes"]), feats[0])
    lg = torch.einsum("bcxyz,nc->bnxyz", quantize(h, precision), w)
    lg = lg + params[f"decoder.seg_layers.{k}.bias"].view(1, -1, 1, 1, 1)
    return lg[0, :, :X, :Y, :Z]


def forward(arch: dict, params: Dict[str, torch.Tensor], window: torch.Tensor,
            precision: str = "f32") -> torch.Tensor:
    """window (X, Y, Z) uint8 -> uint8 probabilities (C, X, Y, Z): softmax
    over the classes, x 255, rounded to nearest (ties to even)."""
    p = torch.softmax(logits(arch, params, window, precision), dim=0)
    return torch.round(p * 255.0).to(torch.uint8)


def param_shapes(arch: dict) -> Sequence[Tuple[str, Tuple[int, ...], str]]:
    """Every parameter: (name, shape, kind), kind one of ``conv``, ``bias``,
    ``norm_weight``, ``norm_bias``, ``transpconv``, ``head``."""
    f = [int(v) for v in arch["features"]]
    depth = len(f)
    out = []

    def block(prefix, cin, cout):
        for j in range(int(arch["convs_per_stage"])):
            c = f"{prefix}.convs.{j}"
            out.append((f"{c}.conv.weight", (cout, cin if j == 0 else cout, 3, 3, 3), "conv"))
            out.append((f"{c}.conv.bias", (cout,), "bias"))
            out.append((f"{c}.norm.weight", (cout,), "norm_weight"))
            out.append((f"{c}.norm.bias", (cout,), "norm_bias"))

    cin = int(arch["in_channels"])
    for s in range(depth):
        block(f"encoder.stages.{s}.0", cin, f[s])
        cin = f[s]
    for k in range(depth - 1):
        s = depth - 2 - k
        out.append((f"decoder.transpconvs.{k}.weight", (f[s + 1], f[s], 2, 2, 2), "transpconv"))
        out.append((f"decoder.transpconvs.{k}.bias", (f[s],), "bias"))
        block(f"decoder.stages.{k}", 2 * f[s], f[s])
    out.append((f"decoder.seg_layers.{depth - 2}.weight", (int(arch["n_classes"]), f[0], 1, 1, 1),
                "head"))
    out.append((f"decoder.seg_layers.{depth - 2}.bias", (int(arch["n_classes"]),), "bias"))
    return out
