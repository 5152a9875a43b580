"""Dense prediction orchestration — pipeline step 1 (counterpart of
``syconn_tpu/exec/exec_dense_prediction.py``).

Each function loads the task's model (``model_path``, falling back to the
packaged weights of the same name) and runs the tiled inference over the
dataset at ``kd_path``, writing probability maps (or 0/255 masks) into the
chunked volumes named by ``target_paths``. Paths are explicit arguments:
the YAML working-directory configuration is not ported yet.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from ..inference.dense import predict_dense_to_kd
from ..io.chunked import ChunkedVolume
from ..models.io import load_model, load_model_meta, packaged_model_path

log = logging.getLogger("syconn_tpu_torch.dense_prediction")

__all__ = ["predict_myelin", "predict_synapsetype", "predict_cellorganelles",
           "predict_er", "predict_golgi"]


def _tile_params(kd_path: str, mag: int, tile_shape=None, halo=None):
    """Deployment tile (256, 256, 128) with halo (32, 32, 16), shrunk for
    small volumes to power-of-two buckets (>= 32) so tile shapes repeat."""
    if tile_shape is None:
        tile_shape = (256, 256, 128)
    if halo is None:
        halo = (32, 32, 16)
    sh = ChunkedVolume.open(kd_path).mag_shape(mag)

    def bucket(t, s):
        return int(min(t, 1 << max(5, int(np.floor(np.log2(max(int(s), 32)))))))

    return tuple(bucket(t, s) for t, s in zip(tile_shape, sh)), tuple(halo)


def _run(task: str, kd_path: str, target_paths: Dict[str, str], channel_mapping: Dict[str, int],
         model_path: Optional[str], mag: int, tile_shape, halo, target_mags, model=None, **kw):
    if model is None:
        model = load_model(model_path or packaged_model_path(task))
    model, params = model
    tile_shape, halo = _tile_params(kd_path, mag, tile_shape, halo)
    stats = predict_dense_to_kd(kd_path, target_paths=target_paths, model=model, params=params,
                                channel_mapping=channel_mapping, mag=mag, tile_shape=tile_shape,
                                halo=halo, target_mags=target_mags, **kw)
    log.info("predict %s: %.1f MVx/s", task, stats["mvox_per_s"])
    return stats


def predict_myelin(kd_path: str, target_paths: Dict[str, str], model_path: Optional[str] = None,
                   mag: Optional[int] = None, tile_shape=None, halo=None, **kw):
    """Myelin map (target ``"myelin"``). ``mag=None`` reads the deployment
    mag from the model meta (fallback 4). With a calibrated ``threshold`` in
    the meta the binary head is thresholded on the card (``p >= thr/255``)
    and read back as bit-packed masks, stored as 0/255."""
    mpath = model_path or packaged_model_path("myelin")
    meta = load_model_meta(mpath)
    if mag is None:
        mag = int(meta.get("mag", 4))
    loaded = load_model(mpath)
    thr = meta.get("threshold")
    thresholds = None
    if thr is not None:
        thresholds = [0.5] * loaded[0].n_classes
        thresholds[1] = float(thr) / 255.0
    return _run("myelin", kd_path, target_paths, {"myelin": 1}, mpath, mag, tile_shape, halo,
                (1,), model=loaded, mode="probs" if thr is None else "masks",
                thresholds=thresholds, **kw)


def predict_synapsetype(kd_path: str, target_paths: Dict[str, str],
                        model_path: Optional[str] = None, mag: int = 1, tile_shape=None,
                        halo=None, **kw):
    """Synapse-type maps (targets ``"asym"``, ``"sym"``)."""
    return _run("syntype", kd_path, target_paths, {"asym": 1, "sym": 2}, model_path, mag,
                tile_shape, halo, (1, 2), **kw)


def predict_cellorganelles(kd_path: str, target_paths: Dict[str, str],
                           model_path: Optional[str] = None, mag: int = 1, tile_shape=None,
                           halo=None, **kw):
    """Organelle maps (targets ``"mi"``, ``"vc"``, ``"sj"``)."""
    return _run("organelles", kd_path, target_paths, {"mi": 1, "vc": 2, "sj": 3}, model_path,
                mag, tile_shape, halo, (1, 2), **kw)


def predict_er(kd_path: str, target_paths: Dict[str, str], model_path: Optional[str] = None,
               mag: int = 1, **kw):
    """ER map (target ``"er"``); probs mode, as the JAX package deploys it."""
    return _run("er", kd_path, target_paths, {"er": 1}, model_path, mag, None, None, (1, 2), **kw)


def predict_golgi(kd_path: str, target_paths: Dict[str, str], model_path: Optional[str] = None,
                  mag: int = 1, **kw):
    """Golgi map (target ``"golgi"``); probs mode, as the JAX package deploys it."""
    return _run("golgi", kd_path, target_paths, {"golgi": 1}, model_path, mag, None, None,
                (1, 2), **kw)
