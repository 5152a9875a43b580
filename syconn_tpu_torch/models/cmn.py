"""Multi-view CMN models (counterpart of ``syconn_tpu/models/cmn.py``):
:class:`MultiViewCMN` (celltype, glia and per-location axoness from view
stacks), :class:`TripletCMN` (morphology embedding) and
:class:`ViewSemSegNet` (per-pixel view segmentation, a small 2D U-Net).

Inputs are channels last, as the flax modules take them: view stacks
(B, V, H, W, C) and single views (N, H, W, C), uint8 value range.
Precision follows flax eager ``apply`` op by op, with one difference: every
sum (conv, dense, the GroupNorm statistics, the means over pixels and
views) accumulates in f64 and is rounded once to f32, where XLA sums in
f32. The products of bf16 (or bf16 x f32) operands are exact in f64 and so,
at these widths, are their sums: a result does not depend on the order of
the sum, and the card gives the CPU's values (cuDNN and the CPU sum in
different orders, and at f32 the differences flip bf16 roundings that the
next layers carry). Against flax the difference stays at XLA's own f32
rounding.

* ``nn.Conv``/``nn.ConvTranspose(dtype=bf16)``: the product of bf16-rounded
  operands, summed, rounded to bf16, plus the bf16 bias (:class:`Conv2d`);
  the 1x1 ``head`` conv and the ``head``/``embed`` ``Dense`` layers are f32
  (:class:`Dense`);
* SAME padding is XLA's: a 3x3 stride-2 conv pads an even extent (0, 1) and
  an odd one (1, 1) (``unet3d.same_pads``), not torch's ``padding=1``; the
  3x3 stride-2 transpose is a stride-1 cross-correlation with the unflipped
  kernel over the input dilated by 2 and padded (2, 1) per axis
  (``unet3d.transpose_pads``), which doubles each extent;
* ``nn.GroupNorm(num_groups=8, dtype=f32)``: statistics over (H, W,
  channels of the group), eps 1e-6, the fast variance
  ``max(E[x^2] - E[x]^2, 0)`` in f32 from the f32 means, ``1 / sqrt`` (both
  devices round it correctly, where CUDA's ``rsqrt`` does not), cast back
  to bf16 by the caller;
* GELU is flax's tanh form op by op in bf16 (``pointnet.flax_gelu``);
* means over pixels and views are rounded to bf16, as ``jnp.mean`` of a
  bf16 array does. Divisions are by tensors on the input's device (PyTorch
  divides a CUDA tensor by a Python scalar as a multiplication by its
  reciprocal).

Submodules carry the flax names (``_ViewTrunk_0``, ``Conv_i``,
``GroupNorm_i``, ``ConvTranspose_i``, ``Dense_0``, ``head``, ``embed``) and
are registered in flax's creation order, so a flax tree maps onto the state
dict one to one (``models/convert.py``) and ``models/io.py`` draws a
seed initialisation in that order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .pointnet import flax_gelu
from .unet3d import _torch_pads, same_pads, transpose_pads

__all__ = ["MultiViewCMN", "TripletCMN", "ViewSemSegNet", "Conv2d", "Dense", "GroupNorm"]

_BF16 = torch.bfloat16


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """IEEE division by ``d`` on ``x``'s device."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _mean(x: torch.Tensor, dims, keepdim: bool = False) -> torch.Tensor:
    """Mean over ``dims``: the f64 sum divided once, rounded to f32."""
    n = 1
    for d in dims:
        n *= x.shape[d]
    return _div(x.double().sum(dim=dims, keepdim=keepdim), float(n)).float()


class Dense(nn.Module):
    """flax ``nn.Dense``; ``weight`` is (out, in) f32. bf16: the bf16-rounded
    operands' products summed, rounded to bf16, plus the bf16 bias; f32:
    f32 operands, the sum rounded to f32, plus the f32 bias."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = _BF16):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            y = x.float().double() @ self.weight.float().double().t()
            return y.float() + self.bias.float()
        y = x.to(_BF16).double() @ self.weight.to(_BF16).double().t()
        return y.float().to(_BF16) + self.bias.to(_BF16)


class Conv2d(nn.Module):
    """flax ``nn.Conv``/``nn.ConvTranspose`` (3x3 SAME or 1x1) on (N, H, W,
    C); ``weight`` is OIHW f32. ``dtype`` bf16: bf16-rounded operands, the
    sum rounded to f32 and then to bf16, plus the bf16 bias; f32: f32
    operands, the sum rounded to f32, plus the f32 bias."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 transpose: bool = False, dtype: torch.dtype = _BF16):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride = (int(stride), int(stride))
        self.transpose = transpose
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            xf, w = x.float().double(), self.weight.float().double()
        else:
            xf, w = x.to(_BF16).double(), self.weight.to(_BF16).double()
        xf = xf.permute(0, 3, 1, 2)
        k = self.weight.shape[-1]
        if self.transpose:
            b, c, H, W = xf.shape
            sh, sw = self.stride
            xd = xf.new_zeros((b, c, (H - 1) * sh + 1, (W - 1) * sw + 1))
            xd[:, :, ::sh, ::sw] = xf
            y = F.conv2d(F.pad(xd, _torch_pads(transpose_pads(self.stride, k))), w)
        else:
            pads = same_pads(xf.shape[2:], self.stride, k)
            y = F.conv2d(F.pad(xf, _torch_pads(pads)), w, stride=self.stride)
        y = y.permute(0, 2, 3, 1)
        if self.dtype == torch.float32:
            return y.float() + self.bias.float()
        return y.float().to(_BF16) + self.bias.to(_BF16)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, dtype=float32)`` on (N, H, W, C):
    eps 1e-6, var = max(E[x^2] - E[x]^2, 0) per (sample, group); f32 out."""

    def __init__(self, c: int, num_groups: int = 8):
        super().__init__()
        self.num_groups = int(num_groups)
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        n, H, W, c = h.shape
        g = h.reshape(n, H, W, self.num_groups, c // self.num_groups)
        mu = _mean(g, (1, 2, 4), keepdim=True)
        mu2 = _mean(g * g, (1, 2, 4), keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        inv = 1.0 / torch.sqrt(var + 1e-6)
        mul = inv.expand(g.shape).reshape(n, H, W, c) * self.scale
        y = (g - mu).reshape(n, H, W, c)
        return y * mul + self.bias


def _gn_gelu(gn: GroupNorm, h: torch.Tensor) -> torch.Tensor:
    return flax_gelu(gn(h).to(_BF16))


def _views_in(x: torch.Tensor) -> torch.Tensor:
    """uint8-range views -> bf16 in [-1, 1]: ``x / 127.5 - 1`` in f32."""
    return (_div(x.float(), 127.5) - 1.0).to(_BF16)


class _ViewTrunk(nn.Module):
    def __init__(self, cin: int, widths: Sequence[int] = (32, 64, 128, 256)):
        super().__init__()
        self.widths = tuple(int(w) for w in widths)
        c = cin
        for i, w in enumerate(self.widths):
            self.add_module(f"Conv_{i}", Conv2d(c, w, stride=2))
            self.add_module(f"GroupNorm_{i}", GroupNorm(w))
            c = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (N, H, W, C)
        h = _views_in(x)
        for i in range(len(self.widths)):
            h = getattr(self, f"Conv_{i}")(h)
            h = _gn_gelu(getattr(self, f"GroupNorm_{i}"), h)
        return _mean(h, (1, 2)).to(_BF16)  # (N, widths[-1])


def _fuse_views(f: torch.Tensor) -> torch.Tensor:
    """(B, V, F) -> (B, 2F): max and mean over the views."""
    return torch.cat([f.amax(dim=1), _mean(f, (1,)).to(f.dtype)], dim=-1)


class MultiViewCMN(nn.Module):
    """View-stack classifier (celltype, glia, per-location axoness): per-view
    conv trunk, permutation-invariant fusion, optional scalar side inputs."""

    def __init__(self, n_classes: int = 8, widths: Sequence[int] = (32, 64, 128, 256),
                 n_scalar: int = 0, n_in: int = 4):
        super().__init__()
        self.n_classes = int(n_classes)
        self.widths = tuple(int(w) for w in widths)
        self.n_scalar = int(n_scalar)
        self.add_module("_ViewTrunk_0", _ViewTrunk(n_in, self.widths))
        self.Dense_0 = Dense(2 * self.widths[-1] + self.n_scalar, 256)
        self.head = Dense(256, self.n_classes, torch.float32)

    def arch_kwargs(self) -> dict:
        return {"n_classes": self.n_classes, "widths": list(self.widths),
                "n_scalar": self.n_scalar, "dtype": "bfloat16"}

    def forward(self, views: torch.Tensor, scalars: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, v = views.shape[0], views.shape[1]
        f = self._ViewTrunk_0(views.reshape((b * v,) + tuple(views.shape[2:]))).reshape(b, v, -1)
        g = _fuse_views(f)
        if self.n_scalar > 0:
            s = scalars if scalars is not None else g.new_zeros((b, self.n_scalar))
            g = torch.cat([g, s.to(g.dtype)], dim=-1)
        return self.head(flax_gelu(self.Dense_0(g)))


class TripletCMN(nn.Module):
    """Morphology-embedding net: the view trunk and a unit-norm embedding."""

    def __init__(self, embed_dim: int = 10, widths: Sequence[int] = (32, 64, 128, 256),
                 n_in: int = 4):
        super().__init__()
        self.embed_dim = int(embed_dim)
        self.widths = tuple(int(w) for w in widths)
        self.add_module("_ViewTrunk_0", _ViewTrunk(n_in, self.widths))
        self.embed = Dense(2 * self.widths[-1], self.embed_dim, torch.float32)

    def arch_kwargs(self) -> dict:
        return {"embed_dim": self.embed_dim, "widths": list(self.widths), "dtype": "bfloat16"}

    def forward(self, views: torch.Tensor) -> torch.Tensor:
        b, v = views.shape[0], views.shape[1]
        f = self._ViewTrunk_0(views.reshape((b * v,) + tuple(views.shape[2:]))).reshape(b, v, -1)
        z = self.embed(_fuse_views(f))
        norm = torch.sqrt((z.double() * z.double()).sum(dim=-1, keepdim=True)).float()
        return z / torch.clamp(norm, min=1e-6)


class ViewSemSegNet(nn.Module):
    """Per-pixel view segmentation: a 2D U-Net over single views."""

    def __init__(self, n_classes: int = 5, widths: Sequence[int] = (32, 64, 128), n_in: int = 4):
        super().__init__()
        self.n_classes = int(n_classes)
        self.widths = tuple(int(w) for w in widths)
        ws = self.widths
        conv, gn = 0, 0
        self._down = []
        c = n_in
        for i, w in enumerate(ws):
            self.add_module(f"Conv_{conv}", Conv2d(c, w))
            self.add_module(f"GroupNorm_{gn}", GroupNorm(w))
            self._down.append((f"Conv_{conv}", f"GroupNorm_{gn}",
                               f"Conv_{conv + 1}" if i < len(ws) - 1 else None))
            conv, gn = conv + 1, gn + 1
            if i < len(ws) - 1:
                self.add_module(f"Conv_{conv}", Conv2d(w, ws[i + 1], stride=2))
                conv += 1
            c = ws[i + 1] if i < len(ws) - 1 else w
        self._up = []
        for k, i in enumerate(reversed(range(len(ws) - 1))):
            self.add_module(f"ConvTranspose_{k}", Conv2d(c, ws[i], stride=2, transpose=True))
            self.add_module(f"Conv_{conv}", Conv2d(2 * ws[i], ws[i]))
            self.add_module(f"GroupNorm_{gn}", GroupNorm(ws[i]))
            self._up.append((f"ConvTranspose_{k}", f"Conv_{conv}", f"GroupNorm_{gn}"))
            conv, gn = conv + 1, gn + 1
            c = ws[i]
        self.head = Conv2d(c, self.n_classes, kernel=1, dtype=torch.float32)

    def arch_kwargs(self) -> dict:
        return {"n_classes": self.n_classes, "widths": list(self.widths), "dtype": "bfloat16"}

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (N, H, W, C)
        h = _views_in(x)
        skips = []
        for conv, gn, down in self._down:
            h = _gn_gelu(getattr(self, gn), getattr(self, conv)(h))
            if down is not None:
                skips.append(h)
                h = getattr(self, down)(h)
        for (up, conv, gn), skip in zip(self._up, reversed(skips)):
            h = torch.cat([getattr(self, up)(h), skip], dim=-1)
            h = _gn_gelu(getattr(self, gn), getattr(self, conv)(h))
        return self.head(h)
