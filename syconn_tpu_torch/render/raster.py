"""Orthographic multi-view renderer (point splat, z-buffered), as PyTorch ops
on an explicit device (counterpart of ``syconn_tpu/render/raster.py``).

Every vertex of a cell mesh is projected into every (location, view) frame
of a chunk of locations; a ``scatter_reduce_(..., "amin")`` over the flat
pixel index ``frame * W * H + ix * H + iy`` is the z-buffer, and a second
``scatter_reduce_(..., "amax")`` over the vertices at the winning depth
gives the index view (equal depths keep the largest vertex index, as the
JAX package's masked scatter-max does).

Bit equality with the JAX package on the CPU. The view transform
``(verts - center) @ rot.T`` is evaluated as explicit elementwise products
and sums in XLA:CPU's order (no matmul, so neither cuBLAS nor TF32 can
change a bit): XLA evaluates one location's ``(V, 3) x (3, 3 * nb_views)``
product with a multiply-then-add chain ``(d0 r0 + d1 r1) + d2 r2`` in some
output columns and a fused multiply-add chain
``fma(d2, r2, fma(d1, r1, d0 r0))`` in the others (:func:`fused_columns`;
measured against jax 0.9's XLA:CPU, ``tests/test_torch_render.py``). A fused
multiply-add of f32 operands is evaluated in f64 and rounded once to f32.
Divisions are by a tensor on the frame's device: PyTorch divides a CUDA
tensor by a Python scalar as a multiplication by its reciprocal, which is
not IEEE division. Validity is tested on the float (``0 <= px < W``), which
equals the JAX test on ``floor(px)`` cast to int32 for every finite value.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, default_device

__all__ = ["render_views_splat", "SplatRenderer", "view_rotations", "fused_columns",
           "BACKGROUND"]

BACKGROUND = 255

# Renders from the threads of ``parallel.executor.map_parallel`` take turns on
# the device: each holds the lock for its transfers, scatters and readback.
DEVICE_LOCK = threading.Lock()


def view_rotations(rot: np.ndarray, nb_views: int) -> np.ndarray:
    """Per-location view matrices: the base (PCA) rotation turned about the
    first principal axis by ``pi * v / nb_views`` for each view ``v``."""
    rots = []
    for v in range(nb_views):
        ang = np.pi * v / nb_views
        c, s = np.cos(ang), np.sin(ang)
        spin = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        rots.append(spin @ rot)
    return np.stack(rots)  # (nb_views, 3, 3)


def fused_columns(nb_views: int) -> np.ndarray:
    """(nb_views, 3) bool: which output columns of one location's
    ``(V, 3) x (3, 3 * nb_views)`` view transform XLA:CPU sums with fused
    multiply-adds (the others: multiply, then add left to right). One view:
    the last column; two views: the last two of six; three or more: all."""
    n = 3 * int(nb_views)
    cols = np.ones(n, bool)
    if nb_views == 1:
        cols[:2] = False
    elif nb_views == 2:
        cols[:4] = False
    return cols.reshape(int(nb_views), 3)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once: the f64 product of two f32 values is
    exact, the f64 sum is rounded, then the f32 result."""
    return (a.double() * b.double() + c.double()).float()


def _view_frame(d: torch.Tensor, rotm: torch.Tensor, fused: torch.Tensor) -> torch.Tensor:
    """p[l, v, i, j] = sum_k d[l, i, k] * rotm[l, v, j, k] in XLA:CPU's order.

    d (Lb, V, 3) f32, rotm (Lb, nv, 3, 3) f32, fused (nv, 3) bool ->
    (Lb, nv, V, 3) f32."""
    dk = [d[:, None, :, k] for k in range(3)]  # (Lb, 1, V)
    comps = []
    for j in range(3):
        r = [rotm[:, :, j, k, None] for k in range(3)]  # (Lb, nv, 1)
        p0 = dk[0] * r[0]
        seq = (p0 + dk[1] * r[1]) + dk[2] * r[2]
        if bool(fused[:, j].any()):
            fm = _fma(dk[2], r[2], _fma(dk[1], r[1], p0))
            seq = torch.where(fused[None, :, j, None], fm, seq)
        comps.append(seq)
    return torch.stack(comps, dim=-1)


def _render_chunk(verts: torch.Tensor, centers: torch.Tensor, rotm: torch.Tensor,
                  window: torch.Tensor, ws: Tuple[int, int], fused: torch.Tensor):
    """One chunk of locations on ``verts``' device: centers (Lb, 3), rotm
    (Lb, nv, 3, 3) -> depth (Lb, nv, W, H) uint8, index (Lb, nv, W, H) int32."""
    W, H = ws
    lb, nv = rotm.shape[0], rotm.shape[1]
    n_v = verts.shape[0]
    p = _view_frame(verts[None] - centers[:, None], rotm, fused)  # (Lb, nv, V, 3)
    px = (p[..., 0] / window + 0.5) * W
    py = (p[..., 1] / (window * H / W) + 0.5) * H
    depth = p[..., 2] / window + 0.5
    valid = ((px >= 0) & (px < W) & (py >= 0) & (py < H) & (depth >= 0.0) & (depth <= 1.0))
    sel = valid.reshape(-1).nonzero().squeeze(1)  # flat (frame, vertex) positions
    frame = torch.div(sel, n_v, rounding_mode="floor")
    vidx = (sel - frame * n_v).to(torch.int32)
    pix = (frame * (W * H) + torch.floor(px.reshape(-1)[sel]).long() * H
           + torch.floor(py.reshape(-1)[sel]).long())
    d_q = depth.reshape(-1)[sel]
    n_pix = lb * nv * W * H
    zbuf = torch.full((n_pix,), float("inf"), dtype=torch.float32, device=verts.device)
    zbuf.scatter_reduce_(0, pix, d_q, "amin")
    win = zbuf[pix] == d_q
    ibuf = torch.full((n_pix,), -1, dtype=torch.int32, device=verts.device)
    ibuf.scatter_reduce_(0, pix[win], vidx[win], "amax")
    depth_img = torch.where(torch.isfinite(zbuf), torch.round(zbuf * 254.0),
                            torch.full_like(zbuf, float(BACKGROUND))).to(torch.uint8)
    return depth_img.reshape(lb, nv, W, H), ibuf.reshape(lb, nv, W, H)


class SplatRenderer:
    """Renders (location, view) frames of one vertex cloud on ``device``
    (``None``: the CUDA card, which must exist).

    ``stats`` (optional dict) accumulates, per call of :meth:`render`,
    ``render_calls``, ``render_frames`` (location x view frames) and
    ``render_seconds`` (wall time of the device part, readback included,
    waiting for the lock excluded)."""

    def __init__(self, ws: Tuple[int, int] = (256, 128), nb_views: int = 2,
                 device: DeviceLike = None):
        self.ws = tuple(int(x) for x in ws)
        self.nb_views = int(nb_views)
        self.device = default_device(device)

    def render(self, vertices_nm: np.ndarray, locations_nm: np.ndarray, rotations: np.ndarray,
               comp_window: float, loc_batch: int = 16, stats: Optional[dict] = None):
        """Render all locations.

        Args:
            vertices_nm: (V, 3).
            locations_nm: (L, 3) view-box centers.
            rotations: (L, 3, 3) base rotations (PCA); expanded to
                ``nb_views`` per location.
        Returns:
            depth views (L, nb_views, W, H) uint8 (255 = background),
            index views (L, nb_views, W, H) int32 (vertex id, -1 = bg).
        """
        v = np.asarray(vertices_nm, np.float32).reshape(-1, 3)
        L = len(locations_nm)
        if L == 0 or len(v) == 0:
            return (np.full((L, self.nb_views, *self.ws), BACKGROUND, np.uint8),
                    np.full((L, self.nb_views, *self.ws), -1, np.int32))
        rotm = np.stack([view_rotations(r, self.nb_views) for r in rotations]).astype(np.float32)
        locs = np.asarray(locations_nm, np.float32).reshape(-1, 3)
        depth_out = np.empty((L, self.nb_views, *self.ws), np.uint8)
        index_out = np.empty((L, self.nb_views, *self.ws), np.int32)
        dev = self.device
        with DEVICE_LOCK:
            t0 = time.perf_counter()
            verts = torch.from_numpy(v).to(dev)
            window = torch.tensor(float(comp_window), dtype=torch.float32, device=dev)
            fused = torch.from_numpy(fused_columns(self.nb_views)).to(dev)
            for i in range(0, L, loc_batch):
                cb = torch.from_numpy(locs[i:i + loc_batch]).to(dev)
                rb = torch.from_numpy(rotm[i:i + loc_batch]).to(dev)
                d, ix = _render_chunk(verts, cb, rb, window, self.ws, fused)
                depth_out[i:i + len(cb)] = d.cpu().numpy()
                index_out[i:i + len(cb)] = ix.cpu().numpy()
            if stats is not None:
                stats["render_calls"] = stats.get("render_calls", 0) + 1
                stats["render_frames"] = stats.get("render_frames", 0) + L * self.nb_views
                stats["render_seconds"] = (stats.get("render_seconds", 0.0)
                                           + time.perf_counter() - t0)
        return depth_out, index_out


def render_views_splat(vertices_nm: np.ndarray, locations_nm: np.ndarray,
                       rotations: Optional[np.ndarray] = None, comp_window: float = 8000.0,
                       ws: Tuple[int, int] = (256, 128), nb_views: int = 2,
                       device: DeviceLike = None):
    """Convenience wrapper; identity rotations when none are given."""
    if rotations is None:
        rotations = np.tile(np.eye(3, dtype=np.float32), (len(locations_nm), 1, 1))
    r = SplatRenderer(ws=ws, nb_views=nb_views, device=device)
    return r.render(vertices_nm, locations_nm, rotations, comp_window)
