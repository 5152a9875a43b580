"""Connected components of binary masks as PyTorch ops on a device
(counterpart of ``syconn_tpu/ops/cc_jax.py``).

Every masked voxel starts with its own flat index + 1; then rounds of

* **relabel-min** — every voxel takes the minimum label over its 6
  neighbours (one vectorised pass), and
* **pointer jumping** — ``label = label[label - 1]`` gathers chase the label
  chains, three per round,

run until a round changes nothing. The JAX package tests convergence on the
device inside ``lax.while_loop``; here each round ends in one host sync (the
change test) and the loop body has no other.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.device import default_device

__all__ = ["connected_components_device", "connected_components_torch"]


def _neighbor_min(lab: torch.Tensor, big: int) -> torch.Tensor:
    m = torch.where(lab > 0, lab, torch.full_like(lab, big))
    best = m.clone()
    for ax in range(3):
        n = m.shape[ax]
        # lo[i] = m[i + 1], hi[i] = m[i - 1]; the missing neighbour is big
        lo = best.narrow(ax, 0, n - 1)
        lo.copy_(torch.minimum(lo, m.narrow(ax, 1, n - 1)))
        hi = best.narrow(ax, 1, n - 1)
        hi.copy_(torch.minimum(hi, m.narrow(ax, 0, n - 1)))
    return torch.where((lab > 0) & (best < big), torch.minimum(lab, best), lab)


def _jump(lab: torch.Tensor) -> torch.Tensor:
    flat = lab.reshape(-1)
    pos = flat > 0
    parent = torch.where(pos, flat - 1, torch.zeros_like(flat)).long()
    chased = torch.where(pos, flat[parent], torch.zeros_like(flat))
    return torch.minimum(flat, torch.where(chased > 0, chased, flat)).reshape(lab.shape)


@torch.no_grad()
def connected_components_device(mask: torch.Tensor) -> torch.Tensor:
    """Label the 6-connected components of a 3D bool mask on its device.

    Returns an int32 volume where every component carries the flat index
    (+1) of its smallest-index voxel; background is 0 (the contract of
    ``cc_jax.connected_components_device``). The flat index must fit int32.
    """
    if mask.dim() != 3:
        raise ValueError(f"need a 3D mask, got shape {tuple(mask.shape)}")
    n = mask.numel()
    if n + 2 >= 2**31:
        raise ValueError(f"{n} voxels: flat labels need int32")
    idx = torch.arange(1, n + 1, dtype=torch.int32, device=mask.device).reshape(mask.shape)
    labels = torch.where(mask.bool(), idx, torch.zeros_like(idx))
    del idx
    big = n + 2
    while True:
        new = _neighbor_min(labels, big)
        for _ in range(3):
            new = _jump(new)
        changed = bool(torch.any(new != labels))
        labels = new
        if not changed:
            return labels


def connected_components_torch(mask: np.ndarray, device=None) -> Tuple[np.ndarray, int]:
    """scipy's ``ndimage.label`` contract on a torch device: compact labels
    1..K in first-occurrence (C scan) order as uint32, plus K. Mirrors
    ``cc_jax.connected_components_tpu``; the compaction runs on the device.
    ``device``: None means the CUDA card (required); ``"cpu"`` runs the same
    ops on the CPU."""
    device = default_device(device)
    mask = np.ascontiguousarray(np.asarray(mask, bool))
    if not mask.any():
        return np.zeros(mask.shape, np.uint32), 0
    raw = connected_components_device(torch.from_numpy(mask).to(device)).reshape(-1)
    nz = raw > 0
    # roots are the flat indices (+1) of each component's smallest voxel,
    # which is also its first voxel in C order: ascending unique roots give
    # scipy's first-occurrence numbering
    roots = torch.unique(raw[nz])
    out = torch.zeros_like(raw)
    out[nz] = (torch.searchsorted(roots, raw[nz]) + 1).to(torch.int32)
    return out.reshape(mask.shape).cpu().numpy().astype(np.uint32), int(roots.numel())
