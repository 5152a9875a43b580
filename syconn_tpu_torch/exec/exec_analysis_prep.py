"""Dataset-specific analysis caching (counterpart of
``syconn_tpu/exec/exec_analysis_prep.py``; host code)."""

from __future__ import annotations

import numpy as np

from .. import global_params

__all__ = ["find_full_cells"]


def find_full_cells(min_path_length_um: float = 10.0) -> np.ndarray:
    """IDs of cells whose skeleton cable length exceeds the threshold —
    a proxy for 'fully reconstructed' cells used by analysis notebooks."""
    from ..reps.super_segmentation import SuperSegmentationDataset

    cfg = global_params.config
    ssd = SuperSegmentationDataset(working_dir=cfg.working_dir)
    scale = np.array(cfg["scaling"], np.float64)
    out = []
    for ssv_id in ssd.ssv_ids:
        ssv = ssd.get_super_segmentation_object(int(ssv_id))
        if not ssv.load_skeleton():
            continue
        sk = ssv.skeleton
        nodes = np.asarray(sk["nodes"], np.float64) * scale[None]
        edges = np.asarray(sk["edges"], np.int64).reshape(-1, 2)
        if len(edges) == 0:
            continue
        length_um = np.linalg.norm(nodes[edges[:, 0]] - nodes[edges[:, 1]], axis=1).sum() / 1e3
        if length_um >= min_path_length_um:
            out.append(int(ssv_id))
    arr = np.array(sorted(out), np.uint64)
    ssd.save_numpy_data("full_cell_id", arr)
    return arr
