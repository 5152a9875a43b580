"""Binary morphology with anisotropic structuring elements and Gaussian blur
(counterpart of ``syconn_tpu/ops/morphology.py``; scipy).

The structuring element is dilated in the xy-plane by the z/x voxel-size
ratio so operations act isotropically in nanometers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from scipy import ndimage

__all__ = [
    "get_aniso_struct",
    "apply_morphological_operations",
    "multi_mop_backgroundonly",
    "gaussian_blur",
    "morphology_halo",
]

_MOPS = {
    "binary_opening": ndimage.binary_opening,
    "binary_closing": ndimage.binary_closing,
    "binary_erosion": ndimage.binary_erosion,
    "binary_dilation": ndimage.binary_dilation,
}


def get_aniso_struct(scale: Sequence[float]) -> np.ndarray:
    """3D structuring element stretched in xy by the anisotropy factor
    (reference: proc/image.py:522): a diamond of radius ``z/x`` in-plane,
    one voxel in z — so one application acts ~isotropically in nanometers.
    """
    scale = np.asarray(scale, dtype=np.float32)
    r = int(max(1, round(scale[2] / scale[0])))
    size = 2 * r + 1
    dx, dy = np.meshgrid(np.arange(size) - r, np.arange(size) - r, indexing="ij")
    plane = (np.abs(dx) + np.abs(dy)) <= r
    struct = np.zeros((size, size, 3), dtype=bool)
    struct[:, :, 1] = plane
    struct[r, r, :] = True
    return struct


def apply_morphological_operations(
    mask: np.ndarray,
    operations: Sequence[str],
    mop_kwargs: Optional[dict] = None,
    struct: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Apply a named chain of binary ops (reference: proc/image.py:485)."""
    if mop_kwargs is None:
        mop_kwargs = {}
    mask = np.asarray(mask).astype(bool)
    for op_name in operations:
        op = _MOPS[op_name]
        mask = op(mask, structure=struct, **mop_kwargs)
    return mask


def multi_mop_backgroundonly(
    op_name: str, seg: np.ndarray, iterations: int = 1, struct: Optional[np.ndarray] = None
) -> np.ndarray:
    """Apply closing/dilation per label such that only background voxels are
    (re-)assigned — existing foreground labels are never overwritten
    (reference: proc/image.py:459, used for per-CS closing+dilation).

    Works on per-label bounding-box crops (padded by the operation's
    support) so cost scales with object size, not volume size.
    """
    seg = np.asarray(seg)
    nz = seg != 0
    if not nz.any():  # typical for sparse objects (e.g. contact sites)
        return seg.copy()
    out = seg.copy()
    # compact labels for find_objects; unique over the nonzero voxels only
    # (a full-volume return_inverse argsort dominated the synapse step)
    uniq = np.unique(seg[nz])
    compact = (np.searchsorted(uniq, seg) + 1).astype(np.int32)
    compact[~nz] = 0
    slices = ndimage.find_objects(compact)
    pad = iterations * (max(struct.shape) // 2 if struct is not None else 1) + 1
    for k, lab in enumerate(uniq):
        sl = slices[k]
        if sl is None:
            continue
        psl = tuple(
            slice(max(0, s.start - pad), min(seg.shape[d], s.stop + pad))
            for d, s in enumerate(sl)
        )
        mask = seg[psl] == lab
        if op_name == "binary_closing":
            grown = ndimage.binary_closing(mask, structure=struct, iterations=iterations)
        elif op_name == "binary_dilation":
            grown = ndimage.binary_dilation(mask, structure=struct, iterations=iterations)
        else:
            raise ValueError(op_name)
        region = out[psl]
        region[grown & (region == 0)] = lab
    return out


def gaussian_blur(arr: np.ndarray, sigma) -> np.ndarray:
    """Separable Gaussian blur (float32 output)."""
    return ndimage.gaussian_filter(np.asarray(arr, dtype=np.float32), sigma=sigma)


def morphology_halo(operations: Sequence[str], sigma=0, struct_extent: int = 1) -> int:
    """Conservative halo (voxels) covering a blur + morphology chain: the
    blur's 3 sigma plus one structuring-element reach per pass (opening and
    closing are two passes each), plus one."""
    halo = int(np.ceil(3 * float(np.max(sigma)))) if np.any(np.asarray(sigma) > 0) else 0
    passes = sum(2 if op in ("binary_opening", "binary_closing") else 1 for op in operations)
    return halo + passes * struct_extent + 1
