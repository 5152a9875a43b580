"""A U-Net split along z over a spatial mesh axis (the port's counterpart of
what XLA's SPMD partitioner makes of ``P(data, None, None, "sp", None)`` in
``syconn_tpu/models/train.py::make_train_step``).

* *The split rule* (:func:`split_extents`): z is cut at multiples of the
  model's z downsampling ``f = patch_z * prod(strides_z)``
  (:func:`z_unit`) into ``sp`` pieces as equal as possible, the first ones
  a unit longer where the units do not divide. Every shard then has a whole
  number of voxels at every level and an even extent wherever a stride-2
  conv runs, so ``space_to_depth`` and the strided convs stay local. XLA
  pads uneven shards instead; both give the single-device result.
* *The z-halo exchange* (``halo.halo_exchange`` along z): each shard gets
  its neighbours' border slices, copied to its device with ``place()``,
  and zeros at the volume's two ends (flax's SAME zero padding). It is
  built from slicing, ``.to()`` and ``cat``, so autograd adds each halo's
  gradient back onto the neighbour's border.
* *Sharded forms* of ``Conv3d`` (:func:`sharded_conv`), ``ConvBlock``
  (:func:`sharded_block`) and ``UNet3D.forward`` (:func:`unet_forward`)
  that run the model's own modules on each shard; LayerNorm, GELU, the
  1x1x1 head, the skip concatenation and ``depth_to_space`` are per voxel
  and stay local.

Halo widths in z, in input voxels of a level, follow from ``same_pads``
and ``transpose_pads`` at the global extent (:func:`z_halo`): a 3x3x3 conv
of stride 1 takes (1, 1); a stride-2 conv (0, 1), flax's SAME pads of an
even extent; a stride-2 transpose (1, 0) and one more zero at the tail of
its dilated input; a stride-1 transpose (1, 1). The pads are asymmetric:
a halo of 1 on both sides everywhere would be wrong at every seam.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..models.unet3d import _BF16, flax_gelu, same_pads, transpose_pads
from .device import on_device
from .halo import halo_exchange

__all__ = ["z_unit", "split_extents", "split_z", "z_halo", "sharded_conv", "sharded_block",
           "unet_forward"]

Z = 3  # z of a channels-last (B, X, Y, Z, C) volume and of (B, X, Y, Z) labels


def z_unit(model) -> int:
    """``patch_z * prod(strides_z)``: the z downsampling of a ``UNet3D``."""
    return int(model.patch[2]) * int(np.prod([s[2] for s in model.strides], dtype=np.int64))


def split_extents(z: int, n: int, unit: int) -> List[int]:
    """The z extents of ``n`` shards of ``z`` voxels, cut at multiples of
    ``unit``, as equal as possible (the first ones longer). Raises
    ``ValueError`` where ``z`` is no multiple of ``unit`` or holds fewer
    than ``n`` units."""
    z, n, unit = int(z), int(n), int(unit)
    if z % unit or z // unit < n:
        raise ValueError(f"z extent {z} does not split over {n} spatial shards: it must be a "
                         f"multiple of the model's z downsampling f = {unit} (patch_z x "
                         f"prod(strides_z)) holding at least {n} units of f")
    q, r = divmod(z // unit, n)
    return [(q + (i < r)) * unit for i in range(n)]


def split_z(t: torch.Tensor, n: int, unit: int) -> List[torch.Tensor]:
    """``t`` (channels-last volume or labels) cut along z by
    :func:`split_extents`: views, in order."""
    return list(torch.split(t, split_extents(t.shape[Z], n, unit), dim=Z))


def z_halo(conv, z: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((halo before, halo after) in input voxels, (lo, hi) zeros the
    haloed shard still pads in z) of the port's ``Conv3d`` on a level of
    ``z`` voxels split at multiples of its z stride.

    A conv's output o reads inputs ``s*o - lo .. s*o - lo + k - 1`` (SAME
    pads (lo, hi) at the global extent), so a shard of whole strides needs
    ``lo`` before and ``k - s - lo`` (= hi) after. A transpose's output o
    reads the dilated input ``o - lo .. o - lo + k - 1`` (``transpose_pads``
    (lo, hi)): ``lo // s`` inputs before, the inputs up to ``(k - 2 - lo) //
    s`` after, and the dilated positions no input covers as zeros."""
    k, s = int(conv.weight.shape[-1]), int(conv.stride[2])
    if not conv.transpose:
        return tuple(same_pads([z], [s], k)[0]), (0, 0)
    lo = transpose_pads([s], k)[0][0]
    before, after = lo // s, max((k - 2 - lo) // s + 1, 0)
    return (before, after), (lo - s * before, k - 2 - lo + s - s * after)


def sharded_conv(convs: Sequence, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One ``Conv3d`` over z shards: ``convs[i]`` (the module, or its
    replica on shard i's device) on shard i with its halo. Equals the
    unsharded conv's output cut at the shards' output extents."""
    s = int(convs[0].stride[2])
    if not convs[0].transpose and any(x.shape[Z] % s for x in xs):
        raise ValueError(f"z shards {[x.shape[Z] for x in xs]} must be whole multiples of the "
                         f"conv's z stride {s}")
    (before, after), z_pads = z_halo(convs[0], sum(x.shape[Z] for x in xs))
    out = []
    for conv, xh in zip(convs, halo_exchange(xs, before, after, Z, edge_mode="zero")):
        with on_device(xh.device):
            out.append(conv(xh, z_pads=z_pads))
    return out


def sharded_block(blocks: Sequence, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``ConvBlock.forward`` over z shards: each conv with its halo, the
    LayerNorm and GELU per shard."""
    for i in range(2):
        xs = sharded_conv([getattr(b, f"Conv_{i}") for b in blocks], xs)
        xs = [flax_gelu(getattr(b, f"LayerNorm_{i}")(x).to(_BF16)) for b, x in zip(blocks, xs)]
    return xs


def unet_forward(models: Sequence, xs: Sequence[torch.Tensor], full_res: bool = True
                 ) -> List[torch.Tensor]:
    """``UNet3D.forward`` over z shards of the raw input: ``models[i]``
    (the model, or its replica on shard i's device) runs shard i, every
    conv with its z halo. Returns the logits of each shard; concatenated
    along z they are the unsharded forward's. Cut ``xs`` with
    :func:`split_z` (units of :func:`z_unit`)."""
    m0 = models[0]
    depth = len(m0.features)
    unit = z_unit(m0)
    if any(x.shape[Z] % unit for x in xs):
        raise ValueError(f"z shards {[x.shape[Z] for x in xs]} must be whole multiples of the "
                         f"model's z downsampling f = {unit}")

    def each(name):
        return [getattr(m, name) for m in models]

    h = [m.stem(x) for m, x in zip(models, xs)]
    skips = []
    for i in range(depth):
        h = sharded_block(each(f"ConvBlock_{i}"), h)
        if i < depth - 1:
            skips.append(h)
            h = sharded_conv(each(f"Conv_{i}"), h)
    for k, i in enumerate(reversed(range(depth - 1))):
        h = sharded_conv(each(f"ConvTranspose_{k}"), h)
        h = [torch.cat([a, b], dim=-1) for a, b in zip(h, skips[i])]
        h = sharded_block(each(f"ConvBlock_{depth + k}"), h)
    return [m.logits(x, full_res) for m, x in zip(models, h)]
