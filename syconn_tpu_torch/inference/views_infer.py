"""View-based (CMN) inference on cells (counterpart of
``syconn_tpu/inference/views_infer.py``): cell types, morphology
embeddings, per-pixel compartments mapped to the mesh and the skeleton,
per-location compartments averaged along the skeleton, and glia
probabilities. Views are rendered on demand (``render/views.py``).

Every function takes ``device`` (``None``: the CUDA card, which must exist;
``"cpu"`` for the plain PyTorch route) and an optional ``stats`` dict that
accumulates ``cells``, ``locations``, ``frames`` (location x view frames
fed to a net), the renderer's ``render_calls``/``render_frames``/
``render_seconds``, and the nets' ``dispatches``/``forward_seconds``
(synchronised by the readback). Device work takes ``render.raster.
DEVICE_LOCK``, so the threads of ``parallel.executor.map_parallel`` take
turns on the card while their host work (PCA rotations, mesh loads,
attribute writes) runs in parallel.

The nets run at the widths the JAX package's functions build them with. Without
trained weights, ``views.allow_untrained_models`` decides whether a
missing net is seed-initialised and persisted (``models/io.py::
get_or_init_model``) or raises.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import global_params
from ..render.raster import DEVICE_LOCK
from ..utils.device import DeviceLike, default_device
from .points import certainty_estimate

log = logging.getLogger("syconn_tpu_torch.views_infer")

__all__ = [
    "views_to_model_input",
    "celltype_of_sso_views",
    "view_embedding_of_sso",
    "semseg_of_sso_views",
    "gliapred_sso_views",
    "axoness_views_of_sso",
    "average_node_axoness_views",
]

VIEW_WS = (128, 64)  # the inference functions' view size, 2 views a location
BATCH = 8

_MODEL_LOCK = threading.Lock()
_MODELS = {}


def views_to_model_input(views: np.ndarray) -> np.ndarray:
    """(L, nb_views, C, W, H) renderer output -> (L, nb_views, W, H, C)."""
    return np.moveaxis(np.asarray(views), 2, -1)


def _add(stats: Optional[dict], **kw):
    if stats is not None:
        for k, v in kw.items():
            stats[k] = stats.get(k, 0) + v


def _get_view_model(mpath: str, builder, device: torch.device):
    """The view net at ``mpath`` on ``device`` (built once per file and
    device). ``views.allow_untrained_models`` decides whether a missing net
    is seed-initialised and persisted, or raises."""
    from ..models.io import get_or_init_model, load_model, model_exists, packaged_model_path

    cfg = global_params.config
    allow = bool(cfg["views"].get("allow_untrained_models", False))
    name = os.path.basename(os.path.normpath(mpath))
    packaged = packaged_model_path(name)
    if not model_exists(mpath) and os.path.normpath(mpath) == os.path.normpath(packaged):
        # the port's mpath_* name the packaged weights where the working
        # directory has none; a seed-initialised net belongs to the working
        # directory, as in the JAX package
        mpath = os.path.join(cfg.model_dir, name)
    with _MODEL_LOCK:
        if not model_exists(mpath) and not model_exists(packaged):
            get_or_init_model(mpath, builder, require_trained=not allow)
        path = mpath if model_exists(mpath) else packaged
        st = os.stat(os.path.join(path, "params.msgpack"))
        key = (os.path.abspath(path), st.st_mtime_ns, st.st_size, str(device))
        if key not in _MODELS:
            _MODELS[key] = load_model(path)[0].to(device).eval()
        return _MODELS[key]


def _batched_apply(model, x: np.ndarray, device: torch.device, batch: int = BATCH,
                   stats: Optional[dict] = None) -> np.ndarray:
    """Forward ``x`` in batches of ``batch`` (the last zero-padded) on
    ``device``; f32 numpy out."""
    outs = []
    n = len(x)
    with DEVICE_LOCK, torch.no_grad():
        t0 = time.perf_counter()
        for i in range(0, n, batch):
            chunk = x[i:i + batch]
            if len(chunk) < batch:
                pad = np.zeros((batch - len(chunk),) + chunk.shape[1:], chunk.dtype)
                chunk = np.concatenate([chunk, pad])
            out = model(torch.from_numpy(np.ascontiguousarray(chunk)).to(device))
            outs.append(out.float().cpu().numpy())
        _add(stats, dispatches=len(outs), forward_seconds=time.perf_counter() - t0)
    return np.concatenate(outs)[:n]


def _sampled_views(ssv, dev, stats):
    from ..render.views import render_sampled_sso

    views, locs = render_sampled_sso(ssv, ws=VIEW_WS, nb_views=2, device=dev, stats=stats)
    _add(stats, cells=1, locations=len(views), frames=2 * len(views))
    return views, locs


def celltype_of_sso_views(ssv, pred_key: str = "celltype_cnn_e3", save: bool = True,
                          device: DeviceLike = None, stats: Optional[dict] = None):
    """Multi-view cell type: render the sampled views, classify each location
    with the celltype CMN, store the argmax of the mean logits, the logits
    and the certainty."""
    from ..models.cmn import MultiViewCMN

    dev = default_device(device)
    cfg = global_params.config
    views, _ = _sampled_views(ssv, dev, stats)
    if len(views) == 0:
        return None
    model = _get_view_model(cfg.mpath_celltype_e3, lambda: MultiViewCMN(
        n_classes=8, widths=(16, 32, 64), n_in=views.shape[2]), dev)
    logits = _batched_apply(model, views_to_model_input(views).astype(np.float32), dev,
                            stats=stats)
    ssv.load_attr_dict()
    ssv.attr_dict[pred_key] = int(np.argmax(logits.mean(axis=0)))
    ssv.attr_dict[f"{pred_key}_probas"] = logits
    ssv.attr_dict[f"{pred_key}_certainty"] = certainty_estimate(logits)
    if save:
        ssv.save_attr_dict()
    return ssv.attr_dict[pred_key]


def view_embedding_of_sso(ssv, pred_key: str = "latent_morph", save: bool = True,
                          device: DeviceLike = None, stats: Optional[dict] = None):
    """tCMN morphology embedding: the mean of the per-location embeddings."""
    from ..models.cmn import TripletCMN

    dev = default_device(device)
    cfg = global_params.config
    views, _ = _sampled_views(ssv, dev, stats)
    if len(views) == 0:
        return None
    ndim = int(cfg["tcmn"]["ndim_embedding"])
    model = _get_view_model(cfg.mpath_tnet, lambda: TripletCMN(
        embed_dim=ndim, widths=(16, 32, 64), n_in=views.shape[2]), dev)
    z = _batched_apply(model, views_to_model_input(views).astype(np.float32), dev,
                       stats=stats).mean(axis=0)
    ssv.load_attr_dict()
    ssv.attr_dict[pred_key] = z.astype(np.float32)
    if save:
        ssv.save_attr_dict()
    return z


def semseg_of_sso_views(ssv, semseg_key: str = "axoness", n_classes: int = 3,
                        mpath: Optional[str] = None, nb_views: int = 2, ws=VIEW_WS,
                        comp_window: Optional[float] = None, save_skeleton: bool = True,
                        device: DeviceLike = None, stats: Optional[dict] = None):
    """Per-pixel view segmentation -> vertex labels (``{semseg_key}_vertex_
    labels``, ``n_classes`` where no pixel voted) -> skeleton node labels
    (the majority of the 50 nearest labelled vertices) and their
    ``{semseg_key}_avg10000`` window majority."""
    from ..models.cmn import ViewSemSegNet
    from ..render.views import (
        generate_rendering_locs,
        render_sso_coords,
        render_sso_coords_index_views,
        semseg2mesh_via_views,
    )

    dev = default_device(device)
    cfg = global_params.config
    if comp_window is None:
        comp_window = float(cfg["compartments"]["view_properties_semsegax"]["comp_window"])
    verts = np.asarray(ssv.load_mesh("sv")[1], np.float32).reshape(-1, 3)
    if len(verts) == 0:
        return None
    locs = generate_rendering_locs(verts, comp_window / 3)
    # the index views use the depth views' rotations (the JAX package
    # computes the same PCA frames twice)
    views, rots = render_sso_coords(ssv, locs, ws=ws, nb_views=nb_views, comp_window=comp_window,
                                    return_rot_mat=True, device=dev, stats=stats)
    index_views = render_sso_coords_index_views(ssv, locs, ws=ws, nb_views=nb_views,
                                                comp_window=comp_window, rot_mat=rots,
                                                device=dev, stats=stats)
    _add(stats, cells=1, locations=len(locs), frames=nb_views * len(locs))
    if mpath is None:
        mpath = cfg.mpath_axonsem
    model = _get_view_model(mpath, lambda: ViewSemSegNet(
        n_classes=n_classes, widths=(16, 32, 64), n_in=views.shape[2]), dev)
    # flatten (L, V) into the batch; channels last
    x = views_to_model_input(views).astype(np.float32)
    logits = _batched_apply(model, x.reshape((-1,) + x.shape[2:]), dev, stats=stats)
    labels = np.argmax(logits, axis=-1).reshape(index_views.shape)
    vert_labels = semseg2mesh_via_views(index_views, labels, n_vertices=len(verts),
                                        n_classes=n_classes, unpredicted_label=n_classes,
                                        device=dev)
    ssv.attr_dict[f"{semseg_key}_vertex_labels"] = vert_labels.astype(np.int32)
    if save_skeleton and ssv.load_skeleton():
        from scipy import spatial

        from ..proc.skeleton import majorityvote_skeleton_property

        scale = np.asarray(ssv.scaling, np.float64)
        nodes_nm = np.asarray(ssv.skeleton["nodes"], np.float64) * scale[None]
        predicted = vert_labels < n_classes
        if predicted.any():
            tree = spatial.cKDTree(verts[predicted])
            k = min(50, int(predicted.sum()))
            _, ixs = tree.query(nodes_nm, k=k)
            lv = vert_labels[predicted]
            node_labels = np.array(
                [np.bincount(lv[np.atleast_1d(row)].astype(np.int64), minlength=n_classes).argmax()
                 for row in np.atleast_2d(ixs)], np.int64)
            ssv.skeleton[semseg_key] = node_labels
            window = float(cfg["compartments"]["dist_axoness_averaging"])
            ssv.skeleton[f"{semseg_key}_avg10000"] = majorityvote_skeleton_property(
                ssv.skeleton, semseg_key, window, scale)
            ssv.save_skeleton()
    ssv.save_attr_dict()
    return vert_labels


def axoness_views_of_sso(ssv, pred_key: str = "axoness_preds_cnn", save: bool = True,
                         device: DeviceLike = None, stats: Optional[dict] = None):
    """Per-location compartment predictions of one cell by the 3-class view
    CMN; stores them and the locations (``view_locations``).

    Returns (preds (L,), locations (L, 3) nm)."""
    from ..models.cmn import MultiViewCMN

    dev = default_device(device)
    cfg = global_params.config
    views, locs = _sampled_views(ssv, dev, stats)
    if len(views) == 0:
        return np.zeros(0, np.int64), np.zeros((0, 3), np.float32)
    model = _get_view_model(cfg.mpath_axoness_views, lambda: MultiViewCMN(
        n_classes=3, widths=(16, 32, 64), n_in=views.shape[2]), dev)
    logits = _batched_apply(model, views_to_model_input(views).astype(np.float32), dev,
                            stats=stats)
    preds = np.argmax(logits, axis=-1).astype(np.int64)
    ssv.load_attr_dict()
    ssv.attr_dict[pred_key] = preds
    ssv.attr_dict["view_locations"] = np.asarray(locs, np.float32)
    if save:
        ssv.save_attr_dict()
    return preds, np.asarray(locs, np.float32)


def average_node_axoness_views(ssv, pred_key: str = "axoness_preds_cnn",
                               max_dist: float = 10000.0, dest_key: Optional[str] = None,
                               return_res: bool = False, device: DeviceLike = None,
                               stats: Optional[dict] = None):
    """Average per-location compartment predictions along the skeleton: each
    node takes the view index of its nearest location; for each node, the
    nodes within ``max_dist`` nm path length (scipy's multi-source Dijkstra)
    vote with the *unique* view predictions among them, the majority (the
    smallest class among equal counts) becoming the node's label.

    Writes ``skeleton['axoness_avg{max_dist}']`` unless ``return_res``; the
    per-location predictions are computed (on ``device``) where none are
    stored."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra
    from scipy.spatial import cKDTree

    if ssv.skeleton is None and not ssv.load_skeleton():
        log.error("no skeleton for ssv %d; skipping view averaging", ssv.id)
        return None
    sk = ssv.skeleton
    edges = np.asarray(sk.get("edges", np.zeros((0, 2))), np.int64).reshape(-1, 2)
    if len(edges) == 0:
        log.error("zero edges in skeleton of ssv %d; skipping", ssv.id)
        return None
    ssv.load_attr_dict()
    preds = np.asarray(ssv.attr_dict.get(pred_key, []))
    locs = np.asarray(ssv.attr_dict.get("view_locations", np.zeros((0, 3))), np.float64)
    if len(preds) == 0 or len(preds) != len(locs):
        preds, locs = axoness_views_of_sso(ssv, pred_key=pred_key, device=device, stats=stats)
        if len(preds) == 0:
            return None
    scale = np.asarray(ssv.scaling, np.float64)
    nodes_nm = np.asarray(sk["nodes"], np.float64) * scale[None]
    view_ixs = cKDTree(locs).query(nodes_nm, k=1)[1]
    sk["view_ixs"] = view_ixs.astype(np.int64)

    n = len(nodes_nm)
    w = np.linalg.norm(nodes_nm[edges[:, 0]] - nodes_nm[edges[:, 1]], axis=1)
    g = coo_matrix(
        (np.concatenate([w, w]),
         (np.concatenate([edges[:, 0], edges[:, 1]]), np.concatenate([edges[:, 1], edges[:, 0]]))),
        shape=(n, n)).tocsr()
    avg = np.empty(n, preds.dtype)
    chunk = max(1, int(2 ** 22 // max(n, 1)))  # bound the dist-matrix block
    for s in range(0, n, chunk):
        srcs = list(range(s, min(s + chunk, n)))
        dmat = dijkstra(g, directed=False, indices=srcs, limit=float(max_dist))
        for row, src in enumerate(srcs):
            neighs = np.flatnonzero(np.isfinite(dmat[row]))
            uix = np.unique(view_ixs[neighs])
            cls, cnts = np.unique(preds[uix], return_counts=True)
            avg[src] = cls[np.argmax(cnts)]
    if return_res:
        return avg
    sk[f"axoness_avg{int(max_dist)}"] = avg
    return avg


def gliapred_sso_views(ssv, save: bool = True, device: DeviceLike = None,
                       stats: Optional[dict] = None) -> float:
    """Glia probability of a cell: the mean class-1 softmax of the glia CMN
    over its sampled locations."""
    from ..models.cmn import MultiViewCMN

    dev = default_device(device)
    cfg = global_params.config
    views, _ = _sampled_views(ssv, dev, stats)
    if len(views) == 0:
        return 0.0
    model = _get_view_model(cfg.mpath_glia_e3, lambda: MultiViewCMN(
        n_classes=2, widths=(16, 32, 64), n_in=views.shape[2]), dev)
    logits = _batched_apply(model, views_to_model_input(views).astype(np.float32), dev,
                            stats=stats)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    proba = float(probs[:, 1].mean())
    if save:
        ssv.load_attr_dict()
        ssv.attr_dict["glia_probas"] = proba
        ssv.save_attr_dict()
    return proba
