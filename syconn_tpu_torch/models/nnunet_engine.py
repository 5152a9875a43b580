"""Inference engine for :class:`~.nnunet.NNUNet` on the hand-written kernels.

Every 3x3x3 conv is one launch of the wgmma conv kernel with a bias
epilogue (``ops/conv3d.py``): the stride-1 convs as SAME convs, each stage's
stride-2 conv as ``conv_down2x_bias(pad_lo=1)`` (x[2o + d - 1], one launch at
the output's resolution), Cout 320 split over two blocks inside the launch.
Each kernel-2 stride-2 transpose is one launch of
``conv_transpose2x2_bias``, which writes the interleaved output. Each
InstanceNorm + LeakyReLU is the kernel pair of ``ops/instnorm.py``: its
statistics span the whole tile, so it cannot ride in a conv epilogue. The 1x1
head is an f32 matrix product after the last norm. On CPU tensors every op
runs its plain version.

Activations are channels-last bf16, conv weights bf16 (the kernels' (T, Cin,
Cout) layout), biases bf16 (added in bf16 after the accumulator is rounded,
as the kernels do), norm and head parameters and the logits f32, the norm's
statistics f32.

Tracing (``utils/tracing.py``): an ``engine.norm`` span (with the device's
event pair, ``layer``, ``voxels``, ``channels``) around each norm and an
``engine.up`` span around each transpose, inside the predictor's
``engine.forward``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv3d import conv3x3x3_ln_gelu, conv_down2x_bias, conv_transpose2x2_bias
from ..ops.instnorm import instance_norm_lrelu
from ..utils import tracing
from .nnunet import NNUNet

__all__ = ["engine_supported", "device_params", "nnunet_apply_packed"]

# the stem's one input channel, zero-padded to the kernels' channel granule
_STEM_CIN = 8


def engine_supported(model) -> bool:
    return isinstance(model, NNUNet)


def _conv_taps(w: np.ndarray, cin_pad: int, device) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) -> (27, max(Cin, cin_pad), Cout) bf16, the extra
    input channels zero."""
    k = torch.as_tensor(np.asarray(w, np.float32)).permute(2, 3, 4, 1, 0)
    cout, cin = int(k.shape[4]), int(k.shape[3])
    taps = torch.zeros((27, max(cin, cin_pad), cout), dtype=torch.float32)
    taps[:, :cin] = k.reshape(27, cin, cout)
    return taps.to(device=device, dtype=torch.bfloat16).contiguous()


def device_params(params: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """The flat PyTorch-layout dict of :class:`NNUNet` -> the engine's
    tensors on ``device``: 3x3x3 kernels (27, Cin, Cout) bf16 (the stem's Cin
    padded to 8), transposes (8, Cin, Cout) bf16 (tap 4 px + 2 py + pz), conv
    biases bf16, norm parameters f32, the head (f_0, C) and (C,) f32."""
    out: Dict[str, torch.Tensor] = {}
    for name, v in params.items():
        v = np.asarray(v, np.float32)
        if name.endswith("conv.weight"):
            t = _conv_taps(v, _STEM_CIN, device)
        elif name.startswith("decoder.transpconvs") and name.endswith("weight"):
            t = torch.as_tensor(v).permute(2, 3, 4, 0, 1).reshape(8, v.shape[0], v.shape[1])
            t = t.to(device=device, dtype=torch.bfloat16).contiguous()
        elif name.startswith("decoder.seg_layers") and name.endswith("weight"):
            t = torch.as_tensor(v.reshape(v.shape[0], v.shape[1]).T.copy()).to(device)
        elif name.endswith("conv.bias") or name.startswith("decoder.transpconvs"):
            t = torch.as_tensor(v).to(device=device, dtype=torch.bfloat16)
        else:
            t = torch.as_tensor(v).to(device)
        out[name] = t.contiguous()
    return out


def _norm(model: NNUNet, p, prefix: str, h: torch.Tensor, layer: str) -> torch.Tensor:
    with tracing.span("engine.norm", device=h.device, layer=layer,
                      voxels=int(h.shape[0] * h.shape[1] * h.shape[2] * h.shape[3]),
                      channels=int(h.shape[4])):
        return instance_norm_lrelu(h, p[f"{prefix}.norm.weight"], p[f"{prefix}.norm.bias"],
                                   model.norm_eps, model.leaky_slope)


def _stage(model: NNUNet, p, prefix: str, h: torch.Tensor, stride, layer: str) -> torch.Tensor:
    for j in range(2):
        c = f"{prefix}.convs.{j}"
        w, b = p[f"{c}.conv.weight"], p[f"{c}.conv.bias"]
        if j == 0 and tuple(stride) == (2, 2, 2):
            h = conv_down2x_bias(h, w, b, pad_lo=1)
        elif j == 0 and tuple(stride) != (1, 1, 1):
            raise ValueError(f"the engine runs strides 1 and 2, got {tuple(stride)}")
        else:
            h = conv3x3x3_ln_gelu(h, w, b, epilogue="bias")
        h = _norm(model, p, c, h, f"{layer}_norm{j}")
    return h


def nnunet_apply_packed(model: NNUNet, params: Dict[str, torch.Tensor],
                        x: torch.Tensor) -> torch.Tensor:
    """x: (B, X, Y, Z, 1) raw voxels (uint8 range) on the params' device ->
    f32 logits (B, X, Y, Z, n_classes); ``params`` from :func:`device_params`.
    Extents that are not multiples of ``model.divisor`` are zero-padded on
    the high side after the z-score and the logits cropped back."""
    B, X, Y, Z = (int(v) for v in x.shape[:4])
    h = (x.float() - model.intensity_mean) / model.intensity_std
    PX, PY, PZ = model.padded_shape((X, Y, Z))
    h = F.pad(h, (0, _STEM_CIN - 1, 0, PZ - Z, 0, PY - Y, 0, PX - X))
    h = h.to(torch.bfloat16).contiguous()
    skips = []
    for s in range(model.depth):
        h = _stage(model, params, f"encoder.stages.{s}.0", h, model.strides[s], f"enc{s}")
        skips.append(h)
    for k in range(model.depth - 1):
        s = model.depth - 2 - k
        with tracing.span("engine.up", device=h.device, layer=f"up{k}"):
            h = conv_transpose2x2_bias(h, params[f"decoder.transpconvs.{k}.weight"],
                                       params[f"decoder.transpconvs.{k}.bias"])
        h = torch.cat([h, skips[s]], dim=-1)
        skips[s] = None
        h = _stage(model, params, f"decoder.stages.{k}", h, (1, 1, 1), f"dec{k}")
    k = model.depth - 2
    lg = h.float() @ params[f"decoder.seg_layers.{k}.weight"] + params[
        f"decoder.seg_layers.{k}.bias"]
    if (PX, PY, PZ) != (X, Y, Z):
        lg = lg[:, :X, :Y, :Z].contiguous()
    return lg

