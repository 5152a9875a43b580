"""Image and coordinate helpers (counterpart of ``syconn_tpu/proc/image.py``):
the point-in-box test that the spine-head volumes of step 7 use. The
filters of that module (CLAHE, hole filling, single components) come with
the steps that use them.
"""

from __future__ import annotations

import numpy as np

__all__ = ["in_bounding_box"]


def in_bounding_box(coords: np.ndarray, bb) -> np.ndarray:
    """Vectorized point-in-box test. ``bb`` is (center, size): True where
    |coord - center| <= size / 2."""
    coords = np.asarray(coords, np.float64)
    center = np.asarray(bb[0], np.float64)
    size = np.asarray(bb[1], np.float64)
    return np.all(np.abs(coords - center[None]) <= size[None] / 2.0, axis=1)
