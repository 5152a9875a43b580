"""Point-cloud models for cell-level inference (counterpart of
``syconn_tpu/models/pointnet.py``): celltype, glia, compartments, spines and
morphology embeddings.

Inputs are (B, N, 3 + F): normalized xyz + one-hot object type (cell
surface / mi / vc / synapse). A PointNet-style backbone of per-point dense
layers with kNN gather-max stages, then symmetric pooling.

Precision follows the flax modules exactly:

* ``nn.Dense(dtype=bf16)``: the product of bf16-rounded operands, rounded to
  bf16, plus the bf16 bias (:class:`Dense` computes the product in f32, which
  is what XLA does for a bf16 dot, and rounds once);
* ``nn.LayerNorm(dtype=f32)``: eps 1e-6, var = E[x^2] - mu^2
  (:class:`..unet3d.LayerNorm`);
* GELU is flax's tanh form evaluated op by op in the tensor's dtype
  (:func:`flax_gelu`): XLA rounds each op of ``nn.gelu`` on a bf16 array to
  bf16, so ``F.gelu(x, approximate="tanh")``, which rounds once, differs
  from it on ~40% of bf16 values; the ``global_proj`` branch is f32;
* the class net's mean over points accumulates in f32 and rounds to bf16.

Submodules carry the flax names (``_PointBackbone_0``, ``Dense_i``,
``LayerNorm_i``, ``global_proj``, ``cls_head``, ``embed_head``,
``seg_head``), so a flax tree maps onto the state dict one to one
(``models/convert.py::module_state_from_flax``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from .unet3d import LayerNorm, flax_gelu

__all__ = ["PointClassNet", "PointSegNet", "knn_group", "knn_indices", "flax_gelu"]

_BF16 = torch.bfloat16



def knn_indices(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (B, N, k) of each point's k nearest points, nearest first.

    ``jax.lax.top_k(-d2, k)`` orders equal distances by the lower index, and
    duplicated context points make exact ties common. Squared distances are
    summed in f32 in the order of ``jnp.sum((a - b) ** 2, -1)``, each step a
    separate elementwise op (so no fused multiply-add changes a bit between
    the CPU and the card). Selection is on the int64 key
    ``bits(d2) * N + index``: non-negative floats order like their bit
    patterns, so the keys are distinct and the k smallest are JAX's
    neighbours, in JAX's order.
    """
    x = xyz.float()
    d2 = None
    for c in range(3):  # (B, N, N) per coordinate: ((dx^2 + dy^2) + dz^2)
        dc = x[:, :, None, c] - x[:, None, :, c]
        d2 = dc * dc if d2 is None else d2 + dc * dc
    n = d2.shape[-1]
    key = d2.view(torch.int32).to(torch.int64) * n + torch.arange(n, device=d2.device)
    return torch.topk(key, k, dim=-1, largest=False, sorted=True).indices


def knn_group(xyz: torch.Tensor, feats: torch.Tensor, k: int = 16) -> torch.Tensor:
    """Max over each point's k nearest neighbours' features: (B, N, C)."""
    idx = knn_indices(xyz, k)
    b = torch.arange(feats.shape[0], device=feats.device)[:, None, None]
    return feats[b, idx].amax(dim=2)


class Dense(nn.Module):
    """flax ``nn.Dense``; ``weight`` is (out, in) f32. With a bf16 compute
    dtype the product of bf16-rounded operands is rounded to bf16 and the
    bf16 bias added; with f32 everything stays f32."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = _BF16):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return x.float() @ self.weight.float().t() + self.bias.float()
        xf = x.to(_BF16).float()
        wf = self.weight.to(_BF16).float()
        return (xf @ wf.t()).to(_BF16) + self.bias.to(_BF16)


def _ln_gelu(ln: LayerNorm, h: torch.Tensor) -> torch.Tensor:
    return flax_gelu(ln(h).to(_BF16))


class _PointBackbone(nn.Module):
    def __init__(self, cin: int, widths: Sequence[int] = (64, 128, 256), k: int = 16,
                 knn_stages: int = 1):
        super().__init__()
        self.widths = tuple(int(w) for w in widths)
        self.k = int(k)
        self.knn_stages = int(knn_stages)
        c = cin
        for i, w in enumerate(self.widths):
            self.add_module(f"Dense_{i}", Dense(c, w))
            self.add_module(f"LayerNorm_{i}", LayerNorm(w))
            c = 2 * w if i < self.knn_stages else w
        self.out_channels = c

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        xyz = pts[..., :3].float()
        h = pts.to(_BF16)
        for i in range(len(self.widths)):
            h = getattr(self, f"Dense_{i}")(h)
            h = _ln_gelu(getattr(self, f"LayerNorm_{i}"), h)
            if i < self.knn_stages:
                h = torch.cat([h, knn_group(xyz, h, self.k)], dim=-1)
        return h


class PointClassNet(nn.Module):
    """Whole-context classification / embedding net (celltype, triplet
    morphology embeddings). ``n_global`` > 0: the last ``n_global`` input
    channels are per-cell scalars that bypass the backbone and join the
    pooled embedding through ``global_proj``."""

    def __init__(self, n_classes: int = 8, widths: Sequence[int] = (64, 128, 256), k: int = 16,
                 embed_dim: int = 0, knn_stages: int = 1, n_global: int = 0, n_in: int = 7):
        super().__init__()
        self.n_classes = int(n_classes)
        self.widths, self.k, self.knn_stages = tuple(int(w) for w in widths), int(k), int(knn_stages)
        self.embed_dim = int(embed_dim)
        self.n_global = int(n_global)
        self.add_module("_PointBackbone_0", _PointBackbone(n_in, widths, k, knn_stages))
        c = 2 * self._PointBackbone_0.out_channels
        ln = 0
        if self.n_global > 0:
            self.global_proj = Dense(self.n_global, 64, torch.float32)
            self.add_module(f"LayerNorm_{ln}", LayerNorm(64))
            ln += 1
            c += 64
        self.Dense_0 = Dense(c, 256)
        self.add_module(f"LayerNorm_{ln}", LayerNorm(256))
        self._head_ln = f"LayerNorm_{ln}"
        self.cls_head = Dense(256, self.n_classes, torch.float32)
        if self.embed_dim > 0:
            self.embed_head = Dense(256, self.embed_dim, torch.float32)

    def arch_kwargs(self) -> dict:
        """The flax module's fields, in their order (``arch.json``)."""
        return {"n_classes": self.n_classes, "widths": list(self.widths), "k": self.k,
                "embed_dim": self.embed_dim, "dtype": "bfloat16", "knn_stages": self.knn_stages,
                "n_global": self.n_global}

    def forward(self, pts: torch.Tensor) -> Dict[str, torch.Tensor]:
        scal = None
        if self.n_global > 0:
            scal = pts[:, 0, -self.n_global:].float()
            pts = pts[..., : pts.shape[-1] - self.n_global]
        h = self._PointBackbone_0(pts)
        mean = (h.float().sum(dim=1) / h.shape[1]).to(_BF16)
        g = torch.cat([h.amax(dim=1), mean], dim=-1)
        if scal is not None:
            s = flax_gelu(self.LayerNorm_0(self.global_proj(scal)))
            g = torch.cat([g, s.to(g.dtype)], dim=-1)
        g = _ln_gelu(getattr(self, self._head_ln), self.Dense_0(g))
        out = {"logits": self.cls_head(g)}
        if self.embed_dim > 0:
            z = self.embed_head(g)
            out["embedding"] = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(1e-6)
        return out


class PointSegNet(nn.Module):
    """Per-point semantic segmentation (compartments, spines, glia)."""

    def __init__(self, n_classes: int = 3, widths: Sequence[int] = (64, 128, 256), k: int = 16,
                 knn_stages: int = 1, n_in: int = 7):
        super().__init__()
        self.n_classes = int(n_classes)
        self.widths, self.k, self.knn_stages = tuple(int(w) for w in widths), int(k), int(knn_stages)
        self.add_module("_PointBackbone_0", _PointBackbone(n_in, widths, k, knn_stages))
        c = self._PointBackbone_0.out_channels
        self.Dense_0 = Dense(2 * c, 128)
        self.LayerNorm_0 = LayerNorm(128)
        self.seg_head = Dense(128, self.n_classes, torch.float32)

    def arch_kwargs(self) -> dict:
        """The flax module's fields, in their order (``arch.json``)."""
        return {"n_classes": self.n_classes, "widths": list(self.widths), "k": self.k,
                "dtype": "bfloat16", "knn_stages": self.knn_stages}

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        h = self._PointBackbone_0(pts)
        g = h.amax(dim=1, keepdim=True)
        hg = torch.cat([h, g.expand(h.shape)], dim=-1)
        hg = _ln_gelu(self.LayerNorm_0, self.Dense_0(hg))
        return self.seg_head(hg)

