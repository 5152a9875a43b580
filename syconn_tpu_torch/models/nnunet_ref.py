"""Plain float32 reference of :class:`~.nnunet.NNUNet`: nnU-Net's
``PlainConvUNet`` built from ``nn.Conv3d``, ``nn.ConvTranspose3d``,
``nn.InstanceNorm3d`` and ``nn.LeakyReLU``, with the same input z-score and
padding rule, run with TF32 off. It imports no kernel of the port and no
JAX: the tests hold the engine (``models/nnunet_engine.py``) against it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from .nnunet import NNUNet

__all__ = ["PlainConvUNetRef"]


class _ConvNormAct(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, eps: float, slope: float):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, 3, stride=stride, padding=1, bias=True)
        self.norm = nn.InstanceNorm3d(cout, eps=eps, affine=True)
        self.nonlin = nn.LeakyReLU(slope)

    def forward(self, x):
        return self.nonlin(self.norm(self.conv(x)))


class _Stacked(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, eps: float, slope: float):
        super().__init__()
        self.convs = nn.Sequential(_ConvNormAct(cin, cout, stride, eps, slope),
                                   _ConvNormAct(cout, cout, 1, eps, slope))

    def forward(self, x):
        return self.convs(x)


class PlainConvUNetRef(nn.Module):
    """The network of ``model`` in float32; its state dict has the names of
    :meth:`NNUNet.param_shapes` (``load_params`` takes that dict)."""

    def __init__(self, model: NNUNet):
        super().__init__()
        self.model = model
        f, eps, slope = model.features, model.norm_eps, model.leaky_slope
        self.encoder = nn.Module()
        self.encoder.stages = nn.ModuleList()
        cin = model.in_channels
        for s, c in enumerate(f):
            stride = model.strides[s]
            if len(set(stride)) != 1:
                raise ValueError("the reference runs isotropic strides")
            self.encoder.stages.append(nn.Sequential(_Stacked(cin, c, stride[0], eps, slope)))
            cin = c
        self.decoder = nn.Module()
        self.decoder.transpconvs = nn.ModuleList()
        self.decoder.stages = nn.ModuleList()
        seg = {}
        for k in range(model.depth - 1):
            s = model.depth - 2 - k
            self.decoder.transpconvs.append(nn.ConvTranspose3d(f[s + 1], f[s], 2, stride=2))
            self.decoder.stages.append(_Stacked(2 * f[s], f[s], 1, eps, slope))
        seg[str(model.depth - 2)] = nn.Conv3d(f[0], model.n_classes, 1)
        self.decoder.seg_layers = nn.ModuleDict(seg)

    def load_params(self, params: Dict[str, np.ndarray]) -> "PlainConvUNetRef":
        state = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in params.items()}
        self.load_state_dict(state, strict=True)
        return self

    @torch.no_grad()
    def forward(self, window: torch.Tensor) -> torch.Tensor:
        """window (X, Y, Z) uint8 -> f32 logits (n_classes, X, Y, Z), with
        TF32 off for the call."""
        flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return self._forward(window)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags

    def _forward(self, window: torch.Tensor) -> torch.Tensor:
        m = self.model
        X, Y, Z = (int(v) for v in window.shape)
        h = (window.float() - m.intensity_mean) / m.intensity_std
        PX, PY, PZ = m.padded_shape((X, Y, Z))
        h = nn.functional.pad(h, (0, PZ - Z, 0, PY - Y, 0, PX - X))[None, None]
        skips = []
        for stage in self.encoder.stages:
            h = stage(h)
            skips.append(h)
        for k in range(m.depth - 1):
            h = self.decoder.transpconvs[k](h)
            h = torch.cat([h, skips[m.depth - 2 - k]], dim=1)
            h = self.decoder.stages[k](h)
        lg = self.decoder.seg_layers[str(m.depth - 2)](h)[0]
        return lg[:, :X, :Y, :Z]
