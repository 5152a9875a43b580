"""Skeleton generation orchestration, pipeline step 5 (counterpart of
``syconn_tpu/exec/exec_skeleton.py``): TEASAR skeletons of every cell of
the working directory's SSD and, optionally, the myelin flag per node.
``device=None`` means the CUDA card, which must exist (the step itself is
host work: TEASAR in C++, the merge in Python)."""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np

from .. import global_params
from ..handler.config import initialize_logging
from ..utils.device import DeviceLike, default_device

__all__ = ["run_skeleton_generation", "run_kimimaro_skeletonization", "map_myelin_global"]


def run_skeleton_generation(
    map_myelin: Optional[bool] = None,
    cube_size: Optional[Sequence[int]] = None,
    ncores_skelgen: Optional[int] = None,
    device: DeviceLike = None,
    stats: Optional[dict] = None,
):
    """TEASAR skeletons for all cells, then (``map_myelin``; default: when
    the myelin volume exists) the myelin mapping. ``stats`` (optional dict)
    receives the cubes, TEASAR thread-seconds, merge and myelin seconds."""
    lg = initialize_logging("exec_skeleton")
    default_device(device)
    cfg = global_params.config
    if map_myelin is None:
        map_myelin = os.path.isdir(cfg.kd_myelin_path)
    st = {}
    n = run_kimimaro_skeletonization(cube_size=cube_size, n_workers=ncores_skelgen, stats=st)
    lg.info("skeletons for %d cells", n)
    if map_myelin:
        t0 = time.perf_counter()
        map_myelin_global()
        st["myelin_seconds"] = time.perf_counter() - t0
    if stats is not None:
        stats.update(st)
    return n


def run_kimimaro_skeletonization(
    cube_size: Optional[Sequence[int]] = None, n_workers: Optional[int] = None,
    stats: Optional[dict] = None,
) -> int:
    """The TEASAR engine over cubes (``proc/skeleton.py``)."""
    from ..proc.skeleton import generate_skeletons

    return generate_skeletons(cube_size=cube_size, n_workers=n_workers, stats=stats)


def map_myelin_global(n_workers: Optional[int] = None):
    """Probe the myelin volume at every skeleton node (``myelin``) and smooth
    by sliding-window majority vote (``myelin_avg10000``)."""
    lg = initialize_logging("exec_skeleton")
    cfg = global_params.config
    from ..parallel.executor import map_parallel
    from ..proc.skeleton import majorityvote_skeleton_property, map_myelin2coords
    from ..reps.super_segmentation import SuperSegmentationDataset

    ssd = SuperSegmentationDataset(working_dir=cfg.working_dir)
    window = float(cfg["compartments"]["dist_axoness_averaging"])
    scale = np.array(cfg["scaling"], np.float64)

    def work(ssv_id):
        ssv = ssd.get_super_segmentation_object(int(ssv_id))
        if not ssv.load_skeleton():
            return 0
        sk = ssv.skeleton
        myelin = map_myelin2coords(np.asarray(sk["nodes"], np.int64))
        sk["myelin"] = myelin
        sk["myelin_avg10000"] = majorityvote_skeleton_property(sk, "myelin", window, scale)
        ssv.skeleton = sk
        ssv.save_skeleton()
        return 1

    done = sum(map_parallel(work, list(ssd.ssv_ids), n_workers=n_workers))
    lg.info("myelin mapped for %d cells", done)
    return done
