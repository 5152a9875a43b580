"""Contact-site detection by (x, y) tile columns: the hand-written CUDA
kernel, its plain PyTorch version and the host code around them
(counterpart of ``syconn_tpu/ops/contacts_pallas.py``).

The chunk (stencil halo included) is cut into (x, y) tile columns of full z
extent. Each column gets a table of at most ``K`` candidate labels, ascending
and padded with ``INT_MAX``. The kernel (``csrc/contacts.cu``, replacing
``_detect_cs_pallas``) votes at every voxel of every column: the candidate
most frequent in the stencil window wins, the voxel's own label, 0 and
``INT_MAX`` never count, ties go to the candidate visited first. The host
then reassembles the columns, crops the z halo, keeps boundary voxels only
and recomputes the columns whose label diversity overflowed ``K`` with the
exact host kernel.

:func:`detect_cs_columns` runs :func:`detect_cs_columns_ref` for CPU tensors
and launches the kernel for CUDA tensors (raising on what the kernel does
not take); nothing falls back from one to the other. All values are
integers: kernel, plain version and host kernel agree exactly.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import default_device
from .conv3d import LAUNCHES

__all__ = ["detect_cs_columns", "detect_cs_columns_ref", "detect_cs_cuda", "box_sum"]

_INT_MAX = int(np.iinfo(np.int32).max)

# Limits of the packed kernel (csrc/contacts.cu mirrors them in its launcher):
MAX_K = 32          # slots: a 16-bit lane holds the key (count << 5) | (31 - slot)
MAX_TILE = 32       # tx and ty: the y pass keeps half a tile column in registers
MAX_ZX_SUM = 255    # sz * sx: the z and x sums run in byte lanes
MAX_COUNT = 2047    # sx * sy * sz: the count, shifted by 5, fills a 16-bit lane


def check_lane_widths(stencil) -> None:
    """Reject a stencil whose partial sums would overflow a lane of the
    packed kernel's counters (on every device: one contract)."""
    sx, sy, sz = (int(s) for s in stencil)
    if sz * sx > MAX_ZX_SUM or sx * sy * sz > MAX_COUNT:
        raise ValueError(f"stencil {(sx, sy, sz)} overflows the kernel's packed counters: it "
                         f"takes sz*sx <= {MAX_ZX_SUM} and sx*sy*sz <= {MAX_COUNT}")


def box_sum(x: torch.Tensor, sizes: Sequence[int], dims: Sequence[int]) -> torch.Tensor:
    """Separable box sum: out[i] = sum over the window [i, i + s) along each
    of ``dims`` (valid extent, ``n - s + 1``), by cumulative sums in int32."""
    for dim, s in zip(dims, sizes):
        n = x.shape[dim]
        c = F.pad(torch.cumsum(x, dim=dim, dtype=torch.int32),
                  [0, 0] * (x.dim() - 1 - dim) + [1, 0])
        x = c.narrow(dim, s, n + 1 - s) - c.narrow(dim, 0, n + 1 - s)
    return x


def _check_args(seg_padded, offs, cands, stencil, tile_xy):
    if seg_padded.dim() != 3 or offs.dim() != 2 or offs.shape[1] != 2 or cands.dim() != 2 \
            or cands.shape[0] != offs.shape[0]:
        raise ValueError(f"expected seg (Xp, Yp, Z), offs (G, 2), cands (G, K); got "
                         f"{tuple(seg_padded.shape)}, {tuple(offs.shape)}, {tuple(cands.shape)}")
    for name, t in (("seg_padded", seg_padded), ("offs", offs), ("cands", cands)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != seg_padded.device:
            raise ValueError(f"{name} is on {t.device}, expected {seg_padded.device}")
    stencil = tuple(int(s) for s in stencil)
    tile_xy = tuple(int(t) for t in tile_xy)
    if len(stencil) != 3 or len(tile_xy) != 2 or any(s < 1 or s % 2 == 0 for s in stencil):
        raise ValueError(f"stencil must be three odd sizes and tile_xy two, got {stencil}, {tile_xy}")
    return stencil, tile_xy


# ------------------------------------------------------------- plain version
def detect_cs_columns_ref(seg_padded: torch.Tensor, offs: torch.Tensor, cands: torch.Tensor,
                          stencil, tile_xy) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`detect_cs_columns` (same arguments): per
    candidate a one-hot of the column windows, a separable box sum by
    cumulative sums, and the masked strict-``>`` update in table order."""
    (sx, sy, sz), (tx, ty) = _check_args(seg_padded, offs, cands, stencil, tile_xy)
    hx, hy, hz = sx // 2, sy // 2, sz // 2
    Z = seg_padded.shape[2]
    G, K = cands.shape
    wx, wy = tx + sx - 1, ty + sy - 1
    offs_h = offs.cpu().numpy().astype(np.int64)
    if offs_h.min(initial=0) < 0:
        raise ValueError("column origins must be non-negative")
    # voxels outside the volume are label 0: pad x/y up to the last window
    # and z by the stencil halo
    need = offs_h.max(axis=0) + (wx, wy)
    seg_z = F.pad(seg_padded, (hz, hz, 0, max(0, int(need[1]) - seg_padded.shape[1]),
                               0, max(0, int(need[0]) - seg_padded.shape[0])))
    per_batch = max(1, (1 << 25) // (wx * wy * (Z + 2 * hz) * 4))
    lo = torch.empty((G, tx, ty, Z), dtype=torch.int32, device=seg_padded.device)
    hi = torch.empty_like(lo)
    for g0 in range(0, G, per_batch):
        g1 = min(G, g0 + per_batch)
        win = torch.stack([seg_z[ox:ox + wx, oy:oy + wy] for ox, oy in offs_h[g0:g1]])
        center = win[:, hx:hx + tx, hy:hy + ty, hz:hz + Z]
        best_cnt = torch.zeros_like(center)
        best_id = torch.zeros_like(center)
        for k in range(K):
            c = cands[g0:g1, k]
            live = (c != _INT_MAX) & (c != 0)
            if not bool(live.any()):
                continue
            c4 = c[:, None, None, None]
            cnt = box_sum((win == c4).to(torch.int32), (sx, sy, sz), (1, 2, 3))
            cnt = torch.where(live[:, None, None, None] & (center != c4), cnt, 0)
            better = cnt > best_cnt
            best_cnt = torch.where(better, cnt, best_cnt)
            best_id = torch.where(better, c4, best_id)
        hit = best_cnt > 0
        lo[g0:g1] = torch.where(hit, torch.minimum(center, best_id), 0)
        hi[g0:g1] = torch.where(hit, torch.maximum(center, best_id), 0)
    return lo, hi


# -------------------------------------------------------------------- kernel
def detect_cs_columns(seg_padded: torch.Tensor, offs: torch.Tensor, cands: torch.Tensor,
                      stencil, tile_xy) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window majority vote over tile columns.

    Args:
        seg_padded: (Xp, Yp, Z) int32 labels (< 2**31 - 1), stencil halo
            included; voxels outside it count as label 0.
        offs: (G, 2) int32 column origins in ``seg_padded``; column g votes
            at the voxels ``origin + stencil // 2 + [0, tile)`` in x and y.
        cands: (G, K) int32 candidate labels per column, visited in table
            order (ascending, padded with ``INT_MAX``).
        stencil: odd window sizes (sx, sy, sz); tile_xy: (tx, ty).
    Returns:
        ``(lo, hi)``, each (G, tx, ty, Z) int32 over the full z extent (the
        window is cut off at the z ends): ``min/max(center, best)`` where
        the best candidate's count is positive, else 0.
    """
    (sx, sy, sz), (tx, ty) = _check_args(seg_padded, offs, cands, stencil, tile_xy)
    check_lane_widths((sx, sy, sz))
    if seg_padded.device.type == "cpu":
        return detect_cs_columns_ref(seg_padded, offs, cands, (sx, sy, sz), (tx, ty))
    if seg_padded.device.type != "cuda":
        raise ValueError(f"unsupported device {seg_padded.device}")
    for name, t in (("seg_padded", seg_padded), ("offs", offs), ("cands", cands)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Xp, Yp, Z = seg_padded.shape
    G, K = cands.shape
    if max(tx, ty) > MAX_TILE or K > MAX_K or G > 65535 or min(G, K, Z, tx, ty) < 1:
        raise ValueError(f"the kernel takes tx, ty <= {MAX_TILE} (tx*ty <= 1024), K <= {MAX_K}, "
                         f"G <= 65535; got tile {(tx, ty)}, K={K}, G={G}")
    from .build import library

    lib = library("contacts")
    lo = torch.empty((G, tx, ty, Z), dtype=torch.int32, device=seg_padded.device)
    hi = torch.empty_like(lo)
    stream = torch.cuda.current_stream(seg_padded.device).cuda_stream
    with torch.cuda.device(seg_padded.device):
        rc = lib.detect_cs_columns_launch(
            seg_padded.data_ptr(), offs.data_ptr(), cands.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), Xp, Yp, Z, G, K, tx, ty, sx, sy, sz, stream)
    if rc != 0:
        raise RuntimeError(
            f"contact kernel launch failed: {lib.contacts_error_string(rc).decode()} (tile "
            f"{(tx, ty)}, stencil {(sx, sy, sz)}, K={K}; the window must fit shared memory)")
    LAUNCHES["detect_cs_columns"] += 1
    return lo, hi


# ----------------------------------------------------------------- host side
def _column_candidates(seg_padded: np.ndarray, offs: np.ndarray, wx: int, wy: int, K: int):
    """Per-column ascending unique nonzero labels, ``(cands (G, K) int32
    padded with INT_MAX, overflow (G,) bool)``.

    Fast path: when the whole chunk holds <= K labels every column shares
    the chunk's list and the per-column scans are skipped."""
    n = len(offs)
    cands = np.full((n, K), _INT_MAX, np.int32)
    overflow = np.zeros(n, bool)
    gu = np.unique(seg_padded)
    gu = gu[gu != 0]
    if len(gu) <= K:
        cands[:, :len(gu)] = gu[None, :]
        return cands, overflow
    for i, (ox, oy) in enumerate(offs):
        u = np.unique(seg_padded[ox:ox + wx, oy:oy + wy, :])
        u = u[u != 0]
        if len(u) > K:
            overflow[i] = True
            u = u[:K]
        cands[i, :len(u)] = u
    return cands, overflow


def _columns_prep(seg: np.ndarray, stencil, tile_xy, K: int):
    """Host prep: pad the core to a tile multiple, column origins, candidate
    tables. Returns ``(seg_p, offs, cands, overflow, out_shape)``."""
    seg = np.ascontiguousarray(seg)
    if seg.max(initial=0) >= 2**31:
        raise ValueError("the column kernel takes labels < 2**31; use ops.contacts.detect_cs")
    tx, ty = (int(t) for t in tile_xy)
    h = np.array([s // 2 for s in stencil])
    out_shape = np.array(seg.shape) - 2 * h
    gx = int(-(-out_shape[0] // tx))
    gy = int(-(-out_shape[1] // ty))
    pad = [(0, gx * tx - int(out_shape[0])), (0, gy * ty - int(out_shape[1])), (0, 0)]
    seg_p = np.pad(seg.astype(np.int32), pad)
    offs = np.array([(i * tx, j * ty) for i in range(gx) for j in range(gy)], np.int32)
    cands, overflow = _column_candidates(seg_p, offs, tx + 2 * int(h[0]), ty + 2 * int(h[1]), K)
    return seg_p, offs, cands, overflow, out_shape


def _columns_finish(seg, lo_t, hi_t, overflow, offs, stencil, tile_xy, out_shape):
    """Host finish: reassemble the columns, crop the z halo, apply the
    boundary gate, recompute overflow columns with the host kernel."""
    from .contacts import detect_cs, detect_seg_boundaries

    tx, ty = (int(t) for t in tile_xy)
    h = np.array([s // 2 for s in stencil])
    gx = int(-(-out_shape[0] // tx))
    gy = int(-(-out_shape[1] // ty))
    ox, oy, oz = (int(s) for s in out_shape)

    def assemble(t):
        full = t.reshape(gx, gy, tx, ty, t.shape[-1]).transpose(0, 2, 1, 3, 4)
        return full.reshape(gx * tx, gy * ty, -1)[:ox, :oy, h[2]:h[2] + oz].astype(np.uint64)

    packed = (assemble(lo_t) << np.uint64(32)) | assemble(hi_t)
    # the kernel votes everywhere; contacts live on boundary voxels only
    seg32 = seg.astype(np.uint32)
    bdry = detect_seg_boundaries(seg32)
    packed[~bdry[h[0]:h[0] + ox, h[1]:h[1] + oy, h[2]:h[2] + oz]] = 0
    for idx in np.flatnonzero(overflow):
        x0, y0 = int(offs[idx][0]), int(offs[idx][1])
        x1, y1 = min(x0 + tx, ox), min(y0 + ty, oy)
        if x0 >= ox or y0 >= oy:
            continue
        # output voxel (x, y, z) reads input window [x, x + stencil): the
        # column's crop plus full z
        crop = seg32[x0:x1 + 2 * int(h[0]), y0:y1 + 2 * int(h[1]), :]
        packed[x0:x1, y0:y1, :] = detect_cs(crop, stencil=stencil)
    return packed


def detect_cs_cuda(seg: np.ndarray, stencil=(13, 13, 7), tile_xy=(32, 32), K: int = 16,
                   device=None) -> np.ndarray:
    """Packed contact segmentation through the column kernel; same contract
    as :func:`syconn_tpu_torch.ops.contacts.detect_cs` (the input includes
    the stencil halo, the output has valid-convolution shape).

    ``device=None`` means the CUDA card (required); ``"cpu"`` runs the plain
    version."""
    device = default_device(device)
    stencil = tuple(int(s) for s in stencil)
    tile_xy = tuple(int(t) for t in tile_xy)
    seg = np.ascontiguousarray(seg)
    seg_p, offs, cands, overflow, out_shape = _columns_prep(seg, stencil, tile_xy, K)
    lo, hi = detect_cs_columns(
        torch.from_numpy(seg_p).to(device), torch.from_numpy(offs).to(device),
        torch.from_numpy(cands).to(device), stencil, tile_xy)
    return _columns_finish(seg, lo.cpu().numpy(), hi.cpu().numpy(), overflow, offs, stencil,
                           tile_xy, out_shape)
