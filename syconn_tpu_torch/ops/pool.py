"""Mean pooling of the dense step's class maps to mag 2, from the packed
patched head output, in plain PyTorch on the tensor's device.

The chunk store pools a tile to mag 2 on the host by casting it to float32,
edge-padding it to even extents and taking the mean of each 2x2x2 block
(``io/chunked.py``, ``_save_multi_mag``). For uint8 maps that mean is exact
in float32 and its truncation to uint8 is ``(sum of the 8) >> 3``, so
:func:`pool_mag2` gives the host's bytes, edge rule included, from the
packed layout the predictor downloads (``inference/dense.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["pool_mag2"]


def _cdiv(a, b):
    return -(-a // b)


def _check_args(packed, extents, patch, n_classes, classes):
    if not isinstance(packed, torch.Tensor) or packed.dtype != torch.uint8:
        raise TypeError(f"packed must be a uint8 tensor, got {getattr(packed, 'dtype', packed)}")
    patch = tuple(int(p) for p in patch)
    if len(patch) != 3 or min(patch) < 1:
        raise ValueError(f"patch must be three sizes >= 1, got {patch}")
    pvox = int(np.prod(patch))
    if packed.dim() != 5 or packed.shape[-1] != n_classes * pvox:
        raise ValueError(f"expected packed (B, sx, sy, sz, {n_classes} * {pvox}), got "
                         f"{tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    tile = np.array(packed.shape[1:4], np.int64) * patch
    ext = np.asarray(extents, np.int64)
    if ext.shape != (packed.shape[0], 3) or ext.min(initial=0) < 0 or np.any(ext > tile):
        raise ValueError(f"extents must be ({packed.shape[0]}, 3) within the tile {tuple(tile)}, "
                         f"got {ext.tolist()}")
    classes = list(range(n_classes)) if classes is None else [int(c) for c in classes]
    if not classes or min(classes) < 0 or max(classes) >= n_classes:
        raise ValueError(f"classes must be indices below {n_classes}, got {classes}")
    return patch, tile, ext, classes


def pool_mag2(packed: torch.Tensor, extents, patch: Sequence[int], n_classes: int,
              classes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Pool classes of a packed patched tile batch to mag 2: the classes'
    voxels unpacked, each row's crop edge-padded by clamped indices, the
    2x2x2 sums in int32 shifted by 3.

    Args:
        packed: (B, sx, sy, sz, n_classes * prod(patch)) uint8, contiguous:
            the predictor's output, voxel (i * px + a, j * py + b, k * pz + c)
            of class ch at position (i, j, k), byte
            ``ch * pvox + (a * py + b) * pz + c``.
        extents: (B, 3) integers, each row's crop extent inside the volume
            (at most the tile ``(sx * px, sy * py, sz * pz)``; a row with a 0
            only pads the batch).
        classes: the classes to pool, in output order (default: all).
    Returns:
        (B, K, ceil(sx * px / 2), ceil(sy * py / 2), ceil(sz * pz / 2))
        uint8 on ``packed``'s device: inside ``ceil(extent / 2)`` the sum of
        each 2x2x2 block >> 3, voxel indices clamped to ``extent - 1`` (the
        chunk store's edge-padded mean, truncated); 0 elsewhere.
    """
    (px, py, pz), tile, ext, classes = _check_args(packed, extents, patch, n_classes, classes)
    b, sx, sy, sz, _ = packed.shape
    half = [_cdiv(int(t), 2) for t in tile]
    out = torch.zeros((b, len(classes), *half), dtype=torch.uint8, device=packed.device)
    vox = packed.reshape(b, sx, sy, sz, n_classes, px, py, pz)[:, :, :, :, classes]
    vox = vox.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(b, len(classes), *(int(t) for t in tile))
    for row, e in enumerate(ext):
        if e.min() == 0:
            continue
        h = [_cdiv(int(x), 2) for x in e]
        ix, iy, iz = (torch.arange(2 * n, device=packed.device).clamp_(max=int(x) - 1)
                      for n, x in zip(h, e))
        v = vox[row][:, ix][:, :, iy][:, :, :, iz].to(torch.int32)
        s = v.reshape(len(classes), h[0], 2, h[1], 2, h[2], 2).sum((2, 4, 6))
        out[row, :, :h[0], :h[1], :h[2]] = (s >> 3).to(torch.uint8)
    return out


