"""Carry flax parameter trees over to the port.

Flax names are kept: ``ConvBlock_i/Conv_j/{kernel,bias}``,
``ConvBlock_i/LayerNorm_j/{scale,bias}``, ``Conv_i`` (stride-2 down convs),
``ConvTranspose_k`` (k = 0 is the deepest level) and ``head``.

* :func:`params_from_flax` gives the engine's parameters: 3x3x3 kernels as
  ``(27, Cin, Cout)`` bf16 (the kernels' layout), their biases bf16,
  LayerNorm parameters f32, the 1x1x1 head as ``(Cin, Nh)`` + ``(Nh,)`` f32
  — the dtypes the JAX engine casts to before its kernels.
* :func:`module_state_from_flax` gives the plain :class:`UNet3D` module's
  state dict, kernels as OIDHW f32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["params_from_flax", "module_state_from_flax", "kernel_taps"]


def kernel_taps(k, device=None) -> torch.Tensor:
    """flax DHWIO (3, 3, 3, Cin, Cout) kernel -> (27, Cin, Cout) bf16."""
    k = torch.as_tensor(np.asarray(k, np.float32))
    return k.reshape(27, k.shape[3], k.shape[4]).to(device=device, dtype=torch.bfloat16).contiguous()


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32)).to(device).contiguous()


def _conv_leaf(p: dict, device) -> Dict[str, torch.Tensor]:
    k = np.asarray(p["kernel"])
    if k.shape[:3] == (1, 1, 1):  # 1x1x1 head stays f32
        return {"kernel": _f32(k.reshape(k.shape[3], k.shape[4]), device),
                "bias": _f32(p["bias"], device)}
    return {"kernel": kernel_taps(k, device),
            "bias": _f32(p["bias"], device).to(torch.bfloat16)}


def params_from_flax(tree: dict, device=None) -> dict:
    """flax params tree (numpy leaves) -> nested dict of device tensors."""
    out = {}
    for name, p in tree.items():
        if "kernel" in p:
            out[name] = _conv_leaf(p, device)
        elif "scale" in p:
            out[name] = {k: _f32(v, device) for k, v in p.items()}
        else:
            out[name] = params_from_flax(p, device)
    return out


def module_state_from_flax(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """flax params tree -> :class:`UNet3D` state dict (OIDHW kernels)."""
    sd = {}
    for name, p in tree.items():
        key = f"{prefix}{name}"
        if "kernel" in p:
            k = torch.as_tensor(np.asarray(p["kernel"], np.float32))
            sd[f"{key}.weight"] = k.permute(4, 3, 0, 1, 2).contiguous()
            sd[f"{key}.bias"] = torch.as_tensor(np.asarray(p["bias"], np.float32))
        elif "scale" in p:
            sd[f"{key}.scale"] = torch.as_tensor(np.asarray(p["scale"], np.float32))
            sd[f"{key}.bias"] = torch.as_tensor(np.asarray(p["bias"], np.float32))
        else:
            sd.update(module_state_from_flax(p, prefix=f"{key}."))
    return sd
