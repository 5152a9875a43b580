"""Training-data generators over working directories (counterpart of
``syconn_tpu/models/traindata.py``).

Reference parity: syconn/cnn/TrainData.py — torch datasets over SyConn
working dirs (``CellCloudData`` point clouds, ``CelltypeViews``,
``TripletData*`` :1857-2104, dense GT volumes). Here: numpy batch
generators feeding the train steps (models/train.py); every batch has
static shapes, and for one seed every batch is the JAX package's (the draws
are numpy's; the volumes, clouds and views are the port's, equal to the JAX
package's). ``ViewData`` renders with ``device`` (the card unless
``"cpu"``).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from .. import global_params

__all__ = [
    "DenseVolumeData",
    "CellCloudData",
    "TripletCloudData",
    "ViewData",
]


class DenseVolumeData:
    """(raw, label) tile batches from chunked volumes for 3D U-Net training.

    Labels come from a seg channel (integer classes) or thresholded prob
    maps; tiles are sampled uniformly at random."""

    def __init__(
        self,
        raw_kd_path: str,
        label_fn,
        tile_shape: Sequence[int] = (64, 64, 32),
        batch_size: int = 2,
        seed: int = 0,
        mag: int = 1,
    ):
        from ..handler.basics import kd_factory

        self.kd = kd_factory(raw_kd_path)
        self.label_fn = label_fn  # (offset, size) -> int labels
        self.tile_shape = np.asarray(tile_shape, np.int64)
        self.batch_size = batch_size
        self.mag = mag
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        sh = self.kd.mag_shape(self.mag)
        hi = np.maximum(sh - self.tile_shape, 1)
        while True:
            xs, ys = [], []
            for _ in range(self.batch_size):
                off = np.array([self.rng.integers(0, h) for h in hi])
                raw = self.kd.load_raw(offset=off, size=self.tile_shape, mag=self.mag)
                lab = self.label_fn(off, self.tile_shape)
                xs.append(raw[..., None].astype(np.float32))
                ys.append(lab.astype(np.int32))
            yield np.stack(xs), np.stack(ys)


class CellCloudData:
    """Labeled point contexts per cell (celltype / glia / compartment GT).

    ``label_of(ssv) -> int`` for classification; for segmentation pass
    ``vertex_labels_of(ssv) -> (N,)`` aligned to the cell's point cloud."""

    def __init__(
        self,
        ssd=None,
        label_of=None,
        npoints: int = 1024,
        ctx_size_nm: float = 15_000.0,
        batch_size: int = 4,
        seed: int = 0,
    ):
        from ..reps.super_segmentation import SuperSegmentationDataset

        self.ssd = ssd or SuperSegmentationDataset(
            working_dir=global_params.config.working_dir
        )
        self.label_of = label_of
        self.npoints = npoints
        self.ctx_size_nm = ctx_size_nm
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self._clouds: Dict[int, tuple] = {}

    def _cloud(self, ssv_id: int):
        if ssv_id not in self._clouds:
            from ..inference.points import sso2pointcloud

            ssv = self.ssd.get_super_segmentation_object(int(ssv_id))
            self._clouds[ssv_id] = sso2pointcloud(ssv)
        return self._clouds[ssv_id]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        from ..inference.points import extract_contexts

        ids = [int(i) for i in self.ssd.ssv_ids]
        while True:
            xs, ys = [], []
            for _ in range(self.batch_size):
                ssv_id = ids[self.rng.integers(0, len(ids))]
                coords, types = self._cloud(ssv_id)
                if len(coords) == 0:
                    continue
                ctxs, _ = extract_contexts(
                    coords, types, ctx_size_nm=self.ctx_size_nm,
                    npoints=self.npoints, n_contexts=1, rng=self.rng,
                )
                xs.append(ctxs[0])
                ys.append(int(self.label_of(ssv_id)))
            if not xs:
                continue
            yield np.stack(xs), np.asarray(ys, np.int32)


class TripletCloudData(CellCloudData):
    """(anchor, positive, negative) context triplets for embedding training
    (reference: TrainData.py:1857 ``TripletData_N``)."""

    def __iter__(self):
        from ..inference.points import extract_contexts

        ids = [int(i) for i in self.ssd.ssv_ids]
        while True:
            a_x, p_x, n_x = [], [], []
            for _ in range(self.batch_size):
                if len(ids) < 2:
                    return
                i_a, i_n = self.rng.choice(len(ids), 2, replace=False)
                ca, ta = self._cloud(ids[i_a])
                cn, tn = self._cloud(ids[i_n])
                if len(ca) == 0 or len(cn) == 0:
                    continue
                ctx_a, _ = extract_contexts(ca, ta, self.ctx_size_nm, self.npoints, 2, self.rng)
                ctx_n, _ = extract_contexts(cn, tn, self.ctx_size_nm, self.npoints, 1, self.rng)
                if len(ctx_a) < 2 or len(ctx_n) < 1:
                    continue
                a_x.append(ctx_a[0])
                p_x.append(ctx_a[1])
                n_x.append(ctx_n[0])
            if not a_x:
                continue
            yield np.stack(a_x), np.stack(p_x), np.stack(n_x)


class ViewData:
    """Rendered-view batches with per-cell labels (CMN training;
    reference: TrainData.py:1041/:1198)."""

    def __init__(self, ssd=None, label_of=None, batch_size: int = 2, seed: int = 0,
                 nb_views: int = 2, ws=(128, 64), comp_window: float = 8000.0, device=None):
        from ..reps.super_segmentation import SuperSegmentationDataset

        self.ssd = ssd or SuperSegmentationDataset(
            working_dir=global_params.config.working_dir
        )
        self.label_of = label_of
        self.batch_size = batch_size
        self.nb_views = nb_views
        self.ws = ws
        self.comp_window = comp_window
        self.device = device
        self.rng = np.random.default_rng(seed)
        self._views: Dict[int, np.ndarray] = {}

    def _cell_views(self, ssv_id: int) -> Optional[np.ndarray]:
        if ssv_id not in self._views:
            from ..render.views import render_sampled_sso

            ssv = self.ssd.get_super_segmentation_object(int(ssv_id))
            views, _ = render_sampled_sso(
                ssv, ws=self.ws, nb_views=self.nb_views, comp_window=self.comp_window,
                device=self.device)
            self._views[ssv_id] = views
        return self._views[ssv_id]

    def __iter__(self):
        ids = [int(i) for i in self.ssd.ssv_ids]
        while True:
            xs, ys = [], []
            for _ in range(self.batch_size):
                ssv_id = ids[self.rng.integers(0, len(ids))]
                views = self._cell_views(ssv_id)
                if views is None or len(views) == 0:
                    continue
                li = self.rng.integers(0, len(views))
                # (nb_views, C, W, H) -> (nb_views, W, H, C)
                v = np.moveaxis(views[li], 1, -1)
                xs.append(v)
                ys.append(int(self.label_of(ssv_id)))
            if not xs:
                continue
            yield np.stack(xs), np.asarray(ys, np.int32)
