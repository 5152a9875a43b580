"""Halo exchange over x-sharded volumes (counterpart of
``syconn_tpu/parallel/halo.py``).

A volume splits along x over a mesh axis; before a halo-dependent kernel
runs on a shard, the shard receives its neighbours' border slabs: shard i
the last ``halo`` slabs of shard i-1 and the first ``halo`` of shard i+1,
each copied to shard i's device (``ppermute`` rings in the JAX package,
device-to-device copies here). At the volume's ends the halo replicates
the edge slab (``edge_mode="edge"``) or is zero. :func:`halo_exchange`
takes any dim and unequal widths: the spatially split U-Net
(``spatial.py``) exchanges z halos with it.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from .device import DeviceMesh, data_sharding, on_device, place

__all__ = ["halo_exchange", "halo_exchange_x", "sharded_volume_apply",
           "sharded_boundary_mask"]


def halo_exchange(shards: Sequence[torch.Tensor], before: int, after: int, dim: int = 0,
                  edge_mode: str = "edge") -> List[torch.Tensor]:
    """Each shard padded along ``dim`` with the last ``before`` slabs of the
    shard before it and the first ``after`` of the shard after it, each
    copied to the shard's device; beyond the mesh's ends the edge slab
    replicated (``edge_mode="edge"``) or zeros. Built from slicing,
    :func:`place` and ``cat``, so autograd adds each halo's gradient back
    onto its neighbour's border."""
    n = len(shards)

    def border(i, k, last):
        local, src = shards[i], i - 1 if last else i + 1
        if 0 <= src < n:
            t = shards[src]
            if t.shape[dim] < k:
                raise ValueError(f"a halo of {k} slabs is wider than shard {src} "
                                 f"({t.shape[dim]} slabs along dim {dim})")
            return place(t.narrow(dim, t.shape[dim] - k if last else 0, k), local.device)
        shape = list(local.shape)
        shape[dim] = k
        if edge_mode == "edge":
            return local.narrow(dim, 0 if last else local.shape[dim] - 1, 1).expand(shape)
        return local.new_zeros(shape)

    out = []
    for i, local in enumerate(shards):
        pieces = ([border(i, before, True)] if before else []) + [local]
        if after:
            pieces.append(border(i, after, False))
        out.append(torch.cat(pieces, dim=dim) if len(pieces) > 1 else local)
    return out


def halo_exchange_x(shards: Sequence[torch.Tensor], halo: int, edge_mode: str = "edge"
                    ) -> List[torch.Tensor]:
    """Each shard padded along dim 0 with its neighbours' border slabs (the
    mesh-edge shards with their edge slab replicated, or zeros)."""
    return halo_exchange(shards, halo, halo, 0, edge_mode)


def sharded_volume_apply(kernel: Callable[[torch.Tensor], torch.Tensor], vol,
                         mesh: DeviceMesh, halo: int, axis_name: str = "sp") -> np.ndarray:
    """Apply ``kernel(padded_local) -> core_out`` to a volume split along x
    over ``axis_name``. ``kernel`` sees its shard plus ``halo`` slabs from
    each neighbour, on the shard's device, and returns the unpadded local
    extent along dim 0. Returns the shards' outputs concatenated, on the
    host."""
    n = mesh.shape[axis_name]
    if vol.shape[0] % n:
        raise ValueError(f"x extent {vol.shape[0]} must divide over {n} '{axis_name}' shards")
    t = torch.as_tensor(np.ascontiguousarray(vol)) if isinstance(vol, np.ndarray) else vol
    shards = data_sharding(t, mesh, axis_name, dim=0)
    outs = []
    for padded in halo_exchange_x(shards, halo):
        with on_device(padded.device):
            outs.append(kernel(padded))
    return torch.cat([o.cpu() for o in outs]).numpy()


def sharded_boundary_mask(vol, mesh: DeviceMesh, axis_name: str = "sp") -> np.ndarray:
    """6-neighbourhood boundary detection on a sharded volume: the sharded
    counterpart of ``ops.contacts.detect_seg_boundaries``, the cross-shard
    faces exchanged between devices instead of re-read from disk."""

    def kernel(padded):
        b = torch.zeros(padded.shape, dtype=torch.bool, device=padded.device)
        for ax in range(3):
            d = padded.narrow(ax, 1, padded.shape[ax] - 1) != \
                padded.narrow(ax, 0, padded.shape[ax] - 1)
            b.narrow(ax, 1, padded.shape[ax] - 1).logical_or_(d)
            b.narrow(ax, 0, padded.shape[ax] - 1).logical_or_(d)
        b &= padded != 0
        return b[1:-1]  # crop the exchanged halo

    return sharded_volume_apply(kernel, vol, mesh, halo=1, axis_name=axis_name)
