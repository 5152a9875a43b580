"""Dense prediction orchestration — pipeline step 1 (counterpart of
``syconn_tpu/exec/exec_dense_prediction.py``).

Each function loads the task's model (the config's ``mpath_*``: a model
saved in the working directory, else the packaged weights of that name) and
runs the tiled inference over the raw channel of the dataset at
``kd_seg_path``, writing probability maps (or 0/255 masks) into the chunked
volumes the config names (``kd_mi_path`` …), as in the JAX package.
``kd_path``, ``target_paths`` and ``model_path`` override the configured
paths; the tile defaults to ``tpu.chunk_shape``.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from .. import global_params
from ..inference.dense import predict_dense_to_kd
from ..io.chunked import ChunkedVolume
from ..models.io import load_model, load_model_meta, packaged_model_path

log = logging.getLogger("syconn_tpu_torch.dense_prediction")

__all__ = ["predict_myelin", "predict_synapsetype", "predict_cellorganelles",
           "predict_er", "predict_golgi"]


def _tile_params(kd_path: str, mag: int, tile_shape=None, halo=None):
    """Deployment tile (``tpu.chunk_shape``) with halo (32, 32, 16), shrunk
    for small volumes to power-of-two buckets (>= 32) so tile shapes repeat."""
    if tile_shape is None:
        tile_shape = tuple(global_params.config["tpu"]["chunk_shape"])
    if halo is None:
        halo = (32, 32, 16)
    sh = ChunkedVolume.open(kd_path).mag_shape(mag)

    def bucket(t, s):
        return int(min(t, 1 << max(5, int(np.floor(np.log2(max(int(s), 32)))))))

    return tuple(bucket(t, s) for t, s in zip(tile_shape, sh)), tuple(halo)


def _paths(kd_path: Optional[str], target_paths: Optional[Dict[str, str]],
           configured: Dict[str, str]):
    cfg = global_params.config
    if (kd_path is None or target_paths is None) and cfg.working_dir is None:
        raise ValueError("no working directory: set global_params.wd or pass kd_path and "
                         "target_paths")
    return kd_path or cfg.kd_seg_path, target_paths or configured


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


def predict_myelin(mag: Optional[int] = None, tile_shape=None, halo=None,
                   kd_path: Optional[str] = None, target_paths: Optional[Dict[str, str]] = None,
                   model_path: Optional[str] = None, **kw):
    """Myelin map into ``kd_myelin_path``. ``mag=None`` reads the deployment
    mag from the model meta (fallback 4). With a calibrated ``threshold`` in
    the meta the binary head is thresholded on the card (``p >= thr/255``)
    and read back as bit-packed masks, stored as 0/255."""
    cfg = global_params.config
    kd_path, target_paths = _paths(kd_path, target_paths,
                                   None if cfg.working_dir is None
                                   else {"myelin": cfg.kd_myelin_path})
    mpath = model_path or cfg.mpath_myelin
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


def predict_synapsetype(mag: int = 1, tile_shape=None, halo=None, kd_path: Optional[str] = None,
                        target_paths: Optional[Dict[str, str]] = None,
                        model_path: Optional[str] = None, **kw):
    """Synapse-type maps into ``kd_asym_path`` and ``kd_sym_path``."""
    cfg = global_params.config
    kd_path, target_paths = _paths(kd_path, target_paths, None if cfg.working_dir is None else
                                   {"asym": cfg.kd_asym_path, "sym": cfg.kd_sym_path})
    return _run("syntype", kd_path, target_paths, {"asym": 1, "sym": 2},
                model_path or cfg.mpath_syntype, mag, tile_shape, halo, (1, 2), **kw)


def predict_cellorganelles(mag: int = 1, tile_shape=None, halo=None,
                           kd_path: Optional[str] = None,
                           target_paths: Optional[Dict[str, str]] = None,
                           model_path: Optional[str] = None, **kw):
    """Organelle maps into ``kd_mi_path``, ``kd_vc_path`` and ``kd_sj_path``."""
    cfg = global_params.config
    kd_path, target_paths = _paths(kd_path, target_paths, None if cfg.working_dir is None else
                                   {"mi": cfg.kd_mi_path, "vc": cfg.kd_vc_path,
                                    "sj": cfg.kd_sj_path})
    return _run("organelles", kd_path, target_paths, {"mi": 1, "vc": 2, "sj": 3},
                model_path or cfg.mpath_organelles, mag, tile_shape, halo, (1, 2), **kw)


def predict_er(mag: int = 1, kd_path: Optional[str] = None,
               target_paths: Optional[Dict[str, str]] = None,
               model_path: Optional[str] = None, **kw):
    """ER map into ``kd_er_path``; probs mode, as the JAX package deploys it."""
    cfg = global_params.config
    kd_path, target_paths = _paths(kd_path, target_paths, None if cfg.working_dir is None
                                   else {"er": cfg.kd_er_path})
    return _run("er", kd_path, target_paths, {"er": 1}, model_path or cfg.mpath_er, mag,
                None, None, (1, 2), **kw)


def predict_golgi(mag: int = 1, kd_path: Optional[str] = None,
                  target_paths: Optional[Dict[str, str]] = None,
                  model_path: Optional[str] = None, **kw):
    """Golgi map into ``kd_golgi_path``; probs mode, as the JAX package deploys it."""
    cfg = global_params.config
    kd_path, target_paths = _paths(kd_path, target_paths, None if cfg.working_dir is None
                                   else {"golgi": cfg.kd_golgi_path})
    return _run("golgi", kd_path, target_paths, {"golgi": 1}, model_path or cfg.mpath_golgi,
                mag, None, None, (1, 2), **kw)
