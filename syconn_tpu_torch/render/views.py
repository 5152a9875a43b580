"""Cell multi-view rendering and the transfer of view labels to the mesh
(counterpart of ``syconn_tpu/render/views.py``).

Views are ``(L, nb_views, C, W, H)`` uint8 depth images, one channel per
object type (``VIEW_CHANNELS``: the cell surface, mitochondria, vesicle
clouds, synapses), rendered by ``render/raster.py`` on ``device`` (``None``:
the CUDA card, which must exist). Rotations are per-location PCA frames of
the cell mesh (``proc/meshes.py::calc_rot_matrices``, host). ``stats``
(optional dict) accumulates the renderer's calls, frames and device
seconds (``render_calls``, ``render_frames``, ``render_seconds``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import global_params
from ..proc.meshes import calc_rot_matrices
from ..utils.device import DeviceLike, default_device
from .raster import BACKGROUND, SplatRenderer

__all__ = [
    "VIEW_CHANNELS",
    "generate_rendering_locs",
    "render_sso_coords",
    "render_sso_coords_index_views",
    "render_sso_coords_label_views",
    "render_sampled_sso",
    "semseg2mesh_via_views",
    "write_sv_views_chunked",
]

VIEW_CHANNELS = ["sv", "mi", "vc", "sj"]

# What loading a channel's mesh raises where it is missing: no dataset
# directory or storage file (FileNotFoundError), or no entry for an object
# in a storage or the config (KeyError).
_MISSING_MESH = (FileNotFoundError, KeyError)


def generate_rendering_locs(verts_nm: np.ndarray, ds_factor_nm: float) -> np.ndarray:
    """Rendering locations: one vertex per occupied ``ds_factor_nm`` grid cell
    of the vertex cloud."""
    from ..reps.rep_helper import surface_samples

    return surface_samples(verts_nm, bin_sizes=(ds_factor_nm,) * 3, max_nb_samples=None)


def _view_props(view_props: Optional[dict]) -> Tuple[Tuple[int, int], int, float]:
    cfg = global_params.config
    vp = dict(cfg["views"]["view_properties"])
    if view_props:
        vp.update(view_props)
    return tuple(vp["ws"]), int(vp["nb_views"]), float(vp["comp_window"])


def _channel_mesh(ssv, ch: str):
    """The channel's merged mesh; synapses from ``syn_ssv`` where the cell
    has any, else ``sj``. None where it is missing."""
    if ch == "sj":
        ch = "syn_ssv" if len(ssv.lookup_in_attribute_dict("syn_ssv", [])) else "sj"
    try:
        return ssv.load_mesh(ch)
    except _MISSING_MESH:
        return None


def _identity_rots(n: int) -> np.ndarray:
    return np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))


def render_sso_coords(ssv, coords_nm: np.ndarray, ws: Optional[Tuple[int, int]] = None,
                      nb_views: Optional[int] = None, comp_window: Optional[float] = None,
                      view_props: Optional[dict] = None, return_rot_mat: bool = False,
                      channels: Sequence[str] = VIEW_CHANNELS, device: DeviceLike = None,
                      stats: Optional[dict] = None):
    """Depth views with one channel per object type at ``coords_nm``:
    (L, nb_views, C, W, H) uint8 (and the (L, 3, 3) base rotations with
    ``return_rot_mat``). Unset view properties come from the config's
    ``views.view_properties``."""
    dev = default_device(device)
    dws, dnv, dcw = _view_props(view_props)
    ws = tuple(ws) if ws is not None else dws
    nb_views = nb_views or dnv
    comp_window = comp_window or dcw
    coords_nm = np.asarray(coords_nm, np.float32).reshape(-1, 3)

    cell_verts = np.asarray(ssv.load_mesh("sv")[1], np.float32).reshape(-1, 3)
    rots = (calc_rot_matrices(coords_nm, cell_verts, comp_window) if len(cell_verts)
            else _identity_rots(len(coords_nm)))
    renderer = SplatRenderer(ws=ws, nb_views=nb_views, device=dev)
    out = np.full((len(coords_nm), nb_views, len(channels), ws[0], ws[1]), BACKGROUND, np.uint8)
    for ci, ch in enumerate(channels):
        mesh = _channel_mesh(ssv, ch)
        if mesh is None or len(mesh[1]) == 0:
            continue
        depth, _ = renderer.render(mesh[1], coords_nm, rots, comp_window, stats=stats)
        out[:, :, ci] = depth
    if return_rot_mat:
        return out, rots
    return out


def render_sso_coords_index_views(ssv, coords_nm: np.ndarray, ws: Optional[Tuple[int, int]] = None,
                                  nb_views: Optional[int] = None,
                                  comp_window: Optional[float] = None,
                                  view_props: Optional[dict] = None,
                                  rot_mat: Optional[np.ndarray] = None, device: DeviceLike = None,
                                  stats: Optional[dict] = None):
    """Per-pixel winning cell-mesh vertex indices, -1 on background:
    (L, nb_views, W, H) int32."""
    dev = default_device(device)
    dws, dnv, dcw = _view_props(view_props)
    ws = tuple(ws) if ws is not None else dws
    nb_views = nb_views or dnv
    comp_window = comp_window or dcw
    coords_nm = np.asarray(coords_nm, np.float32).reshape(-1, 3)
    verts = np.asarray(ssv.load_mesh("sv")[1], np.float32).reshape(-1, 3)
    if rot_mat is None:
        rot_mat = (calc_rot_matrices(coords_nm, verts, comp_window) if len(verts)
                   else _identity_rots(len(coords_nm)))
    renderer = SplatRenderer(ws=ws, nb_views=nb_views, device=dev)
    _, index = renderer.render(verts, coords_nm, rot_mat, comp_window, stats=stats)
    return index


def render_sso_coords_label_views(ssv, vertex_labels: np.ndarray, coords_nm: np.ndarray,
                                  background_label: int = -1, **kw):
    """Views of per-vertex labels (``background_label`` on background)."""
    index = render_sso_coords_index_views(ssv, coords_nm, **kw)
    labels = np.asarray(vertex_labels)
    return np.where(index >= 0, labels[np.clip(index, 0, len(labels) - 1)], background_label)


def render_sampled_sso(ssv, ws=None, nb_views=None, comp_window=None, verbose=False,
                       device: DeviceLike = None, stats: Optional[dict] = None):
    """Views at surface-sampled locations of the whole cell (one per
    ``comp_window / 3`` grid cell of its mesh). Returns (views, locations)."""
    dev = default_device(device)
    verts = np.asarray(ssv.load_mesh("sv")[1], np.float32).reshape(-1, 3)
    if len(verts) == 0:
        return np.zeros((0,)), np.zeros((0, 3))
    _, _, dcw = _view_props(None)
    comp_window = comp_window or dcw
    locs = generate_rendering_locs(verts, comp_window / 3)
    views = render_sso_coords(ssv, locs, ws=ws, nb_views=nb_views, comp_window=comp_window,
                              device=dev, stats=stats)
    return views, locs


def semseg2mesh_via_views(index_views: np.ndarray, label_views: np.ndarray, n_vertices: int,
                          n_classes: int, unpredicted_label: Optional[int] = None,
                          device: DeviceLike = None) -> np.ndarray:
    """Per-pixel view labels -> per-vertex labels: the majority of the pixels
    each vertex won (the first class among equal counts), where no pixel
    voted ``unpredicted_label``. Exact integer counts (``torch.bincount``
    of the flat (vertex, class) key)."""
    dev = default_device(device)
    ix = torch.as_tensor(np.asarray(index_views).reshape(-1), device=dev).long()
    lab = torch.as_tensor(np.asarray(label_views).reshape(-1), device=dev).long()
    sel = (ix >= 0) & (lab >= 0) & (lab < n_classes)
    votes = torch.bincount(ix[sel] * n_classes + lab[sel], minlength=n_vertices * n_classes)
    votes = votes[: n_vertices * n_classes].reshape(n_vertices, n_classes)
    out = torch.argmax(votes, dim=1)
    if unpredicted_label is not None:
        out = torch.where(votes.sum(dim=1) == 0, torch.full_like(out, unpredicted_label), out)
    return out.cpu().numpy()


def write_sv_views_chunked(svs, views: np.ndarray, part_views: np.ndarray, view_key: str = "raw"):
    """Write many supervoxels' views into their per-shard view caches with one
    storage open and push per shard (host only).

    Args:
        svs: SegmentationObjects (typically all SVs of one cell).
        views: concatenated view array over all SVs.
        part_views: cumulated view counts; SV ``i`` owns
            ``views[part_views[i]:part_views[i + 1]]``.
        view_key: cache key (e.g. 'raw').
    """
    from ..backend import CompressedStorage

    part_views = np.asarray(part_views, np.int64)
    assert len(part_views) == len(svs) + 1
    by_path = {}
    for i, sv in enumerate(svs):
        by_path.setdefault(sv.view_path, []).append(
            (int(sv.id), int(part_views[i]), int(part_views[i + 1])))
    for path, items in by_path.items():
        cs = CompressedStorage(path, read_only=False)
        for sv_id, lo, hi in items:
            cs[(sv_id, view_key)] = np.asarray(views[lo:hi])
        cs.push()
