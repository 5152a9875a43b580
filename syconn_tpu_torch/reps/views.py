"""View containers (counterpart of ``syconn_tpu/reps/views.py``): rendered
view stacks of one object in a compressed storage ``<view_dir>/views.pkl``."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..backend import CompressedStorage

__all__ = ["ViewContainer"]


class ViewContainer:
    """Compressed storage of rendered view stacks per object."""

    def __init__(self, view_dir: str, views: Optional[np.ndarray] = None):
        self.view_dir = view_dir
        self._views = views

    @property
    def view_path(self) -> str:
        return os.path.join(self.view_dir, "views.pkl")

    def load_views(self, view_key: str = "raw") -> Optional[np.ndarray]:
        if self._views is not None:
            return self._views
        if not os.path.isfile(self.view_path):
            return None
        cs = CompressedStorage(self.view_path, read_only=True, disable_locking=True)
        if view_key in cs:
            self._views = cs[view_key]
        return self._views

    def save_views(self, views: np.ndarray, view_key: str = "raw"):
        os.makedirs(self.view_dir, exist_ok=True)
        cs = CompressedStorage(self.view_path, read_only=False)
        cs[view_key] = np.asarray(views)
        cs.push()
        self._views = views

    def plot(self, path: str, loc: int = 0, view: int = 0, channel: int = 0):
        """One view channel as an image file (needs matplotlib)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        v = self.load_views()
        fig, ax = plt.subplots()
        ax.imshow(v[loc, view, channel].T, cmap="gray", vmin=0, vmax=255)
        ax.set_axis_off()
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
