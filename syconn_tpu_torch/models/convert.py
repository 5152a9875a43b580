"""Carry flax parameter trees over to the port.

Flax names are kept: ``ConvBlock_i/Conv_j/{kernel,bias}``,
``ConvBlock_i/LayerNorm_j/{scale,bias}``, ``Conv_i`` (stride-2 down convs),
``ConvTranspose_k`` (k = 0 is the deepest level) and ``head``.

* :func:`params_from_flax` gives the engine's parameters: 3x3x3 kernels as
  ``(27, Cin, Cout)`` bf16 (the kernels' layout), their biases bf16,
  LayerNorm parameters f32, the 1x1x1 head as ``(Cin, Nh)`` + ``(Nh,)`` f32
  — the dtypes the JAX engine casts to before its kernels.
* :func:`module_state_from_flax` gives the plain modules' state dicts:
  :class:`UNet3D`'s conv kernels as OIDHW f32, the view nets'
  (``models/cmn.py``) 2D ``Conv``/``ConvTranspose`` kernels HWIO as OIHW
  f32, and ``Dense`` kernels (in, out) as ``weight`` (out, in) f32;
  ``LayerNorm``/``GroupNorm`` ``scale`` and ``bias`` as they are.
* :func:`flax_tree_from_module` is its inverse: a module's state as the flax
  params tree of numpy f32 arrays (what ``models/io.py::save_model``
  writes).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["params_from_flax", "module_state_from_flax", "flax_tree_from_module", "kernel_taps"]


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
    """flax params tree -> the port module's state dict: conv kernels
    (spatial..., I, O) -> (O, I, spatial...), dense kernels (in, out) ->
    (out, in)."""
    sd = {}
    for name, p in tree.items():
        key = f"{prefix}{name}"
        if "kernel" in p:
            k = torch.as_tensor(np.asarray(p["kernel"], np.float32))
            n = k.dim()
            k = k.permute(n - 1, n - 2, *range(n - 2))
            sd[f"{key}.weight"] = k.contiguous()
            sd[f"{key}.bias"] = torch.as_tensor(np.asarray(p["bias"], np.float32))
        elif "scale" in p:
            sd[f"{key}.scale"] = torch.as_tensor(np.asarray(p["scale"], np.float32))
            sd[f"{key}.bias"] = torch.as_tensor(np.asarray(p["bias"], np.float32))
        else:
            sd.update(module_state_from_flax(p, prefix=f"{key}."))
    return sd



def flax_tree_from_module(model: torch.nn.Module) -> dict:
    """The module's state as a flax params tree of numpy f32 arrays, keys in
    the module's registration order: (O, I, spatial...) ``weight`` ->
    (spatial..., I, O) ``kernel``; ``scale``/``bias`` as they are."""
    tree: dict = {}
    for key, t in model.state_dict().items():
        *path, leaf = key.split(".")
        a = t.detach().float().cpu()
        if leaf == "weight":
            n = a.dim()
            a, leaf = a.permute(*range(2, n), 1, 0), "kernel"
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a.contiguous().numpy()
    return tree
