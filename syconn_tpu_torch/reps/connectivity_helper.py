"""Connectivity-matrix helpers: partner-ID codecs, wiring arrays, plots
(counterpart of ``syconn_tpu/reps/connectivity_helper.py``; host code).

The two plots import matplotlib inside the function, as the JAX package
does; where matplotlib is not installed they raise ``ImportError``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from .. import global_params

__all__ = [
    "cs_id_to_partner_ids_vec",
    "cs_id_to_partner_inverse",
    "load_cached_data_dict",
    "generate_wiring_array",
    "plot_wiring",
    "plot_cumul_wiring",
]


def cs_id_to_partner_ids_vec(cs_ids) -> np.ndarray:
    """Packed uint64 pair -> (N, 2) partner IDs (high bits first = smaller)."""
    arr = np.asarray(cs_ids, np.uint64).reshape(-1)
    return np.stack([arr >> np.uint64(32), arr & np.uint64(0xFFFFFFFF)], axis=1)


def cs_id_to_partner_inverse(partners) -> np.uint64:
    """(id_a, id_b) -> packed uint64 (smaller ID in the high bits)."""
    a, b = int(partners[0]), int(partners[1])
    lo, hi = (a, b) if a < b else (b, a)
    return np.uint64((lo << 32) | hi)


def load_cached_data_dict(syn_version=None, wd: Optional[str] = None, thresh_syn_prob: Optional[float] = None) -> Dict:
    """Dataset-level synapse caches as a dict (reference: :80)."""
    from .segmentation import SegmentationDataset

    cfg = global_params.config
    wd = wd or cfg.working_dir
    if thresh_syn_prob is None:
        thresh_syn_prob = float(cfg["cell_objects"]["thresh_synssv_proba"])
    sd = SegmentationDataset("syn_ssv", working_dir=wd, version=syn_version)
    out = {}
    for key in [
        "id", "size", "rep_coord", "neuron_partners", "syn_prob", "syn_sign",
        "partner_celltypes", "partner_axoness", "partner_spiness", "asym_prop", "sym_prop",
    ]:
        arr = sd.load_numpy_data(key)
        if arr is not None:
            out[key if key != "id" else "ids"] = arr
    if "syn_prob" in out:
        sel = out["syn_prob"] >= thresh_syn_prob
        out = {k: v[sel] for k, v in out.items()}
    return out


def generate_wiring_array(
    wd: Optional[str] = None,
    log_scale: bool = True,
    thresh_syn_prob: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense (n_cells, n_cells) wiring matrix of summed signed synapse sizes
    (reference: :163). Returns (matrix, cell_ids)."""
    data = load_cached_data_dict(wd=wd, thresh_syn_prob=thresh_syn_prob)
    if "neuron_partners" not in data or len(data.get("ids", [])) == 0:
        return np.zeros((0, 0)), np.zeros(0, np.uint64)
    partners = np.asarray(data["neuron_partners"], np.uint64)
    sizes = np.asarray(data["size"], np.float64)
    signs = np.asarray(data.get("syn_sign", np.ones(len(sizes))), np.float64)
    cells = np.unique(partners)
    ix = {int(c): i for i, c in enumerate(cells)}
    mat = np.zeros((len(cells), len(cells)), np.float64)
    for (a, b), s, sg in zip(partners, sizes, signs):
        mat[ix[int(a)], ix[int(b)]] += sg * s
        mat[ix[int(b)], ix[int(a)]] += sg * s
    if log_scale:
        mat = np.sign(mat) * np.log1p(np.abs(mat))
    return mat, cells


def plot_wiring(path: str, wd: Optional[str] = None, **kw) -> str:
    """Wiring-matrix heatmap (reference: :234)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mat, cells = generate_wiring_array(wd=wd, **kw)
    fig, ax = plt.subplots(figsize=(6, 6))
    if mat.size:
        vmax = np.abs(mat).max() or 1.0
        im = ax.imshow(mat, cmap="coolwarm", vmin=-vmax, vmax=vmax)
        fig.colorbar(im, ax=ax, label="signed log synapse size")
    ax.set_xlabel("postsynaptic cell")
    ax.set_ylabel("presynaptic cell")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_cumul_wiring(path: str, wd: Optional[str] = None, **kw) -> str:
    """Cumulative synapse-size distribution plot (reference: :376)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = load_cached_data_dict(wd=wd)
    fig, ax = plt.subplots(figsize=(6, 4))
    if "size" in data and len(data["size"]):
        sizes = np.sort(np.asarray(data["size"], np.float64))
        ax.plot(sizes, np.linspace(0, 1, len(sizes)))
        ax.set_xscale("log")
    ax.set_xlabel("synapse size (voxels)")
    ax.set_ylabel("cumulative fraction")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path
