"""View and id codecs and rendering-location helpers (counterpart of
``syconn_tpu/handler/multiviews.py``): RGBA id encoding, label palettes and
their inverse, and ``generate_rendering_locs``. The renderer gives integer
index views directly; the codecs serve KNOSSOS and older view files.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "id2rgba_array_contiguous",
    "rgba2id_array",
    "generate_palette",
    "remap_rgb_labelviews",
    "generate_rendering_locs",
]


def id2rgba_array_contiguous(ids: np.ndarray) -> np.ndarray:
    """Contiguous IDs -> RGBA uint8 (little-endian byte split)."""
    arr = np.asarray(ids, np.uint32).reshape(-1)
    return arr.view(np.uint8).reshape(-1, 4).copy()


def rgba2id_array(rgba: np.ndarray) -> np.ndarray:
    """Inverse of :func:`id2rgba_array_contiguous`."""
    arr = np.ascontiguousarray(np.asarray(rgba, np.uint8))
    flat = arr.reshape(-1, 4)
    return flat.view(np.uint32).reshape(arr.shape[:-1]).copy()


def generate_palette(n_classes: int, return_rgba: bool = True) -> np.ndarray:
    """Distinct color palette for label views (needs matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.cm as cm

    cmap = cm.get_cmap("tab20" if n_classes <= 20 else "hsv")
    cols = (np.array([cmap(i / max(n_classes - 1, 1)) for i in range(n_classes)]) * 255).astype(
        np.uint8
    )
    return cols if return_rgba else cols[:, :3]


def remap_rgb_labelviews(views_rgb: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """RGB label views -> integer labels via palette matching."""
    v = np.asarray(views_rgb, np.uint8)
    flat = v.reshape(-1, v.shape[-1])[:, :3].astype(np.int32)
    pal = np.asarray(palette, np.uint8)[:, :3].astype(np.int32)
    d = np.abs(flat[:, None, :] - pal[None]).sum(-1)
    return np.argmin(d, axis=1).reshape(v.shape[:-1]).astype(np.int32)


def generate_rendering_locs(verts_nm: np.ndarray, ds_factor_nm: float) -> np.ndarray:
    """Rendering locations: one vertex per occupied ``ds_factor_nm`` grid cell."""
    from ..render.views import generate_rendering_locs as _impl

    return _impl(verts_nm, ds_factor_nm)
