"""A stand-in model family for the tests, not a cell: a one-level patch net.

Its ``arch`` has keys of its own (``width``, ``fold``, ``classes``; no
``features``, ``strides`` or ``patch``), its weights a layout of their own
(PyTorch's: conv kernels (out, in, 3, 3, 3), a dense head (out, in)), and it
brings its own plain reference and counts. The program runs it as the port's
``UNet3D`` of one level, whose weights ``program_model`` converts.

Network: the window folded space-to-depth by ``fold``, twice a 3x3x3 conv
(padding 1) + bias, LayerNorm over the channels (eps 1e-6), tanh-GELU, then a
1x1x1 head to ``classes * prod(fold)`` logits grouped (class, fold voxel).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.lib.inputs import stream_seed

CONV_KERNELS = ("conv3d_wgmma_kernel", "conv3d_kernel")
_LAYERS = ("stem", "body")


def _dims(arch):
    fold = [int(f) for f in arch["fold"]]
    return fold, int(np.prod(fold)), int(arch["width"]), int(arch["classes"])


def make_params(arch: dict, seed: int, device) -> dict:
    """A flat dict of float32 tensors, one draw a leaf: kernels at
    1/sqrt(fan-in), biases and norm shifts at 0.1, norm gains 1 +- 0.1."""
    _, pvox, w, c = _dims(arch)
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 11))

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=torch.float32)

    out = {}
    for name, cin in zip(_LAYERS, (pvox, w)):
        out[f"{name}.weight"] = randn(w, cin, 3, 3, 3) / math.sqrt(27 * cin)
        out[f"{name}.bias"] = 0.1 * randn(w)
        out[f"{name}.gain"] = 1.0 + 0.1 * randn(w)
        out[f"{name}.shift"] = 0.1 * randn(w)
    out["head.weight"] = randn(c * pvox, w) / math.sqrt(w)
    out["head.bias"] = 0.1 * randn(c * pvox)
    return out


def program_model(arch: dict, params: dict, device):
    """The port's one-level ``UNet3D`` and the flax tree of numpy arrays
    that it takes, converted from this family's layout."""
    from syconn_tpu_torch.models.unet3d import UNet3D

    fold, pvox, w, c = _dims(arch)
    host = {k: v.detach().cpu().numpy() for k, v in params.items()}
    block = {}
    for j, name in enumerate(_LAYERS):
        block[f"Conv_{j}"] = {"kernel": np.ascontiguousarray(
            host[f"{name}.weight"].transpose(2, 3, 4, 1, 0)), "bias": host[f"{name}.bias"]}
        block[f"LayerNorm_{j}"] = {"scale": host[f"{name}.gain"], "bias": host[f"{name}.shift"]}
    head = {"kernel": np.ascontiguousarray(host["head.weight"].T).reshape(1, 1, 1, w, c * pvox),
            "bias": host["head.bias"]}
    model = UNet3D(features=[w], strides=[], patch=fold, n_classes=c)
    return model, {"ConvBlock_0": block, "head": head}


def _quantize(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return x
    scale = 448.0 / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


@torch.no_grad()
def reference_forward(arch: dict, params: dict, window: torch.Tensor,
                      precision: str = "f32") -> torch.Tensor:
    """window (X, Y, Z) uint8 -> uint8 probabilities (C, X, Y, Z); with
    ``"fp8"`` the convs' and the head's operands in float8 e4m3."""
    (px, py, pz), pvox, w, c = _dims(arch)
    X, Y, Z = window.shape
    sx, sy, sz = X // px, Y // py, Z // pz
    h = (window.float() / 127.5 - 1.0).reshape(sx, px, sy, py, sz, pz)
    h = h.permute(1, 3, 5, 0, 2, 4).reshape(1, pvox, sx, sy, sz)
    for name in _LAYERS:
        h = F.conv3d(_quantize(h, precision), _quantize(params[f"{name}.weight"], precision),
                     params[f"{name}.bias"], padding=1)
        mu = h.mean(1, keepdim=True)
        h = (h - mu) * torch.rsqrt(((h - mu) ** 2).mean(1, keepdim=True) + 1e-6)
        h = h * params[f"{name}.gain"].view(1, -1, 1, 1, 1) + params[f"{name}.shift"].view(
            1, -1, 1, 1, 1)
        h = F.gelu(h, approximate="tanh")
    lg = torch.einsum("bixyz,oi->boxyz", _quantize(h, precision), params["head.weight"])
    lg = lg[0] + params["head.bias"].view(-1, 1, 1, 1)
    p = torch.softmax(lg.reshape(c, pvox, sx, sy, sz), dim=0)
    q = torch.round(p * 255.0).to(torch.uint8).reshape(c, px, py, pz, sx, sy, sz)
    return q.permute(0, 4, 1, 5, 2, 6, 3).reshape(c, X, Y, Z)


def flops(arch: dict, in_shape) -> float:
    """2*27*S*Cin*Cout for each 3x3x3 conv and 2*S*Cin*Cout for the head, S
    the folded positions."""
    _, pvox, w, c = _dims(arch)
    S = int(np.prod([int(v) for v in in_shape[:4]])) // pvox
    return float(2 * 27 * S * (pvox * w + w * w) + 2 * S * w * c * pvox)


def conv_launches(arch: dict, in_shape):
    """The two 3x3x3 convs of one forward, bf16 in and out; the head runs
    as a matmul, not a conv launch."""
    _, pvox, w, _ = _dims(arch)
    S = int(np.prod([int(v) for v in in_shape[:4]])) // pvox
    return [dict(kind="same", flops=2 * 27 * S * cin * w,
                 bytes=S * cin * 2 + 27 * cin * w * 2 + w * 2 + S * w * 2)
            for cin in (pvox, w)]
