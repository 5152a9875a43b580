"""Image-level helpers (counterpart of ``syconn_tpu/proc/image.py``):
contrast normalization, CLAHE, hole filling, single components, the
point-in-box test that the spine-head volumes of step 7 use, and the
anisotropic morphology helpers of ``ops/morphology.py``, re-exported here as
in the reference (syconn/proc/image.py :177, :459-530).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from scipy import ndimage

from ..ops.morphology import (  # noqa: F401 (re-exports, as in the reference)
    apply_morphological_operations,
    get_aniso_struct,
    multi_mop_backgroundonly,
)

__all__ = [
    "in_bounding_box",
    "fill_voids",
    "normalize_img",
    "clahe",
    "apply_clahe_slices",
    "apply_morphological_operations",
    "multi_mop_backgroundonly",
    "get_aniso_struct",
    "single_conn_comp",
]


def normalize_img(img: np.ndarray, max_val: float = 255.0) -> np.ndarray:
    """Stretch ``img`` linearly to [0, max_val] as uint8 (zeros if flat)."""
    img = np.asarray(img, np.float32)
    lo, hi = img.min(), img.max()
    if hi == lo:
        return np.zeros_like(img, np.uint8)
    return ((img - lo) / (hi - lo) * max_val).astype(np.uint8)


def clahe(img2d: np.ndarray, clip_limit: float = 2.0, tile: int = 8) -> np.ndarray:
    """Contrast-limited adaptive histogram equalization of one 2D slice:
    clipped CDFs per tile, interpolated bilinearly between tile centres
    (no cv2)."""
    img = np.asarray(img2d, np.uint8)
    h, w = img.shape
    th, tw = max(h // tile, 1), max(w // tile, 1)
    ny, nx = -(-h // th), -(-w // tw)
    cdfs = np.zeros((ny, nx, 256), np.float32)
    for i in range(ny):
        for j in range(nx):
            t = img[i * th : (i + 1) * th, j * tw : (j + 1) * tw]
            hist = np.bincount(t.reshape(-1), minlength=256).astype(np.float32)
            clip = clip_limit * t.size / 256.0
            excess = np.maximum(hist - clip, 0).sum()
            hist = np.minimum(hist, clip) + excess / 256.0
            cdf = np.cumsum(hist)
            cdfs[i, j] = cdf / max(cdf[-1], 1) * 255.0
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    fy = (yy + 0.5) / th - 0.5
    fx = (xx + 0.5) / tw - 0.5
    y0 = np.clip(np.floor(fy).astype(int), 0, ny - 1)
    x0 = np.clip(np.floor(fx).astype(int), 0, nx - 1)
    y1 = np.clip(y0 + 1, 0, ny - 1)
    x1 = np.clip(x0 + 1, 0, nx - 1)
    wy = np.clip(fy - y0, 0, 1)
    wx = np.clip(fx - x0, 0, 1)
    v = img
    out = (
        cdfs[y0, x0, v] * (1 - wy) * (1 - wx)
        + cdfs[y1, x0, v] * wy * (1 - wx)
        + cdfs[y0, x1, v] * (1 - wy) * wx
        + cdfs[y1, x1, v] * wy * wx
    )
    return out.astype(np.uint8)


def apply_clahe_slices(vol: np.ndarray, axis: int = 2, **kw) -> np.ndarray:
    """CLAHE per slice of a 3D volume along ``axis``."""
    vol = np.asarray(vol, np.uint8)
    out = np.empty_like(vol)
    for i in range(vol.shape[axis]):
        sl = [slice(None)] * 3
        sl[axis] = i
        out[tuple(sl)] = clahe(vol[tuple(sl)], **kw)
    return out


def in_bounding_box(coords: np.ndarray, bb) -> np.ndarray:
    """Vectorized point-in-box test. ``bb`` is (center, size): True where
    |coord - center| <= size / 2."""
    coords = np.asarray(coords, np.float64)
    center = np.asarray(bb[0], np.float64)
    size = np.asarray(bb[1], np.float64)
    return np.all(np.abs(coords - center[None]) <= size[None] / 2.0, axis=1)


def fill_voids(mask: np.ndarray) -> np.ndarray:
    """Fill enclosed cavities of a binary mask."""
    return ndimage.binary_fill_holes(np.asarray(mask).astype(bool))


def single_conn_comp(mask: np.ndarray, coord: Optional[Sequence[int]] = None) -> np.ndarray:
    """Keep only the connected component containing ``coord`` (or the
    largest one)."""
    lab, n = ndimage.label(np.asarray(mask).astype(bool))
    if n == 0:
        return np.zeros_like(mask, bool)
    if coord is not None:
        target = lab[tuple(int(c) for c in coord)]
        if target == 0:
            return np.zeros_like(mask, bool)
    else:
        counts = np.bincount(lab.reshape(-1))
        counts[0] = 0
        target = int(np.argmax(counts))
    return lab == target
