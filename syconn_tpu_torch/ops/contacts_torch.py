"""Device contact-site detection in PyTorch ops, and the dispatchers that
feed chunks to the card (counterpart of ``syconn_tpu/ops/contacts_jax.py``).

Same semantics as the host kernel in :mod:`.contacts`: for every boundary
voxel the most frequent foreign label inside the stencil window wins (ties
-> smallest label). Two device formulations exist:

* the per-tile formulation of this module (:func:`detect_cs_device`): the
  chunk is cut into 3D tiles (+ stencil halo); each tile's candidate set
  (its <= K smallest labels) comes from one sort, per-candidate window counts
  from a separable box sum over the one-hot volume, and the winner from a
  maximum over the ascending candidate axis. Plain tensor ops, as the JAX
  package leaves this formulation to XLA;
* the column formulation of :mod:`.contacts_cuda`, whose vote is the
  hand-written CUDA kernel.

Tiles (or columns) with more than K labels are recomputed by the host
kernel. :class:`CsDispatcher` takes chunks from the host and picks the
formulation; :class:`ResidentCsDetector` slices chunks from a volume that
already lives in device memory and reads contact voxels back sparsely.
"""

from __future__ import annotations

import time
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..io.resident import fetch
from ..utils.device import default_device
from .contacts_cuda import box_sum

__all__ = ["detect_cs_device", "detect_cs_torch", "CsDispatcher", "ResidentCsDetector"]

_INT_MAX = int(np.iinfo(np.int32).max)
_TILE_BATCH = 16


def _tile_candidates(flat: torch.Tensor, K: int):
    """flat (B, n) int32 tile windows -> (cands (B, K) ascending unique
    nonzero labels padded with INT_MAX, overflow (B,) bool)."""
    s, _ = torch.sort(flat, dim=1)
    firsts = torch.ones_like(s, dtype=torch.bool)
    firsts[:, 1:] = s[:, 1:] != s[:, :-1]
    firsts &= s != 0
    slot = torch.cumsum(firsts, dim=1) - 1
    overflow = firsts.sum(dim=1) > K
    cands = torch.full((flat.shape[0], K), _INT_MAX, dtype=torch.int32, device=flat.device)
    b, p = torch.nonzero(firsts & (slot < K), as_tuple=True)
    cands[b, slot[b, p]] = s[b, p]
    return cands, overflow


def _tile_kernel(win: torch.Tensor, bdry: torch.Tensor, stencil, K: int):
    """A batch of tiles: win (B, cx+2hx, cy+2hy, cz+2hz) int32 labels, bdry
    (B, cx, cy, cz) boundary mask. Returns (partners (B, core, 2) int32,
    overflow (B,) bool)."""
    hx, hy, hz = stencil[0] // 2, stencil[1] // 2, stencil[2] // 2
    B = win.shape[0]
    cands, overflow = _tile_candidates(win.reshape(B, -1), K)
    cv = cands[:, None, None, None, :]
    counts = box_sum((win[..., None] == cv).to(torch.int32), stencil, (1, 2, 3))
    center = win[:, hx:win.shape[1] - hx, hy:win.shape[2] - hy, hz:win.shape[3] - hz]
    foreign = (cv != center[..., None]) & (cv != _INT_MAX)
    counts = torch.where(foreign, counts, 0)
    # first maximum over the ascending candidates (smallest label wins
    # ties): the maximum of count * K + (K - 1 - slot) decides both
    rank = torch.arange(K - 1, -1, -1, dtype=torch.int32, device=win.device)
    key = (counts * K + rank).amax(dim=-1)
    best_cnt = torch.div(key, K, rounding_mode="floor")
    best_id = torch.gather(cands, 1, (K - 1 - key % K).reshape(B, -1).long()).reshape(key.shape)
    hit = bdry & (best_cnt > 0)
    lo = torch.where(hit, torch.minimum(center, best_id), 0)
    hi = torch.where(hit, torch.maximum(center, best_id), 0)
    return torch.stack([lo, hi], dim=-1), overflow


def _boundaries(seg: torch.Tensor) -> torch.Tensor:
    """Nonzero voxels with a differing 6-neighbor."""
    bdry = torch.zeros(seg.shape, dtype=torch.bool, device=seg.device)
    for ax in range(3):
        d = seg.narrow(ax, 1, seg.shape[ax] - 1) != seg.narrow(ax, 0, seg.shape[ax] - 1)
        bdry.narrow(ax, 1, seg.shape[ax] - 1).logical_or_(d)
        bdry.narrow(ax, 0, seg.shape[ax] - 1).logical_or_(d)
    return bdry & (seg != 0)


@torch.no_grad()
def detect_cs_device(seg: torch.Tensor, stencil: Tuple[int, int, int] = (13, 13, 7),
                     tile: Tuple[int, int, int] = (32, 32, 16), K: int = 32):
    """Contact partners of an int32 label chunk, on the tensor's device.

    ``seg`` must include the stencil halo; the output has valid-convolution
    shape ``seg.shape - stencil + 1`` with channels (low id, high id). Also
    returns the per-tile overflow flags (host fallback selector), shaped
    like the tile grid.
    """
    stencil = tuple(int(s) for s in stencil)
    tile = tuple(int(t) for t in tile)
    h = tuple(s // 2 for s in stencil)
    out_shape = tuple(seg.shape[i] - 2 * h[i] for i in range(3))
    # boundary of the full (haloed) chunk, cropped to the core
    bdry_core = _boundaries(seg)[h[0]:h[0] + out_shape[0], h[1]:h[1] + out_shape[1],
                                 h[2]:h[2] + out_shape[2]]
    # pad the core to a tile multiple (zeros on the high side)
    grid = tuple(-(-out_shape[i] // tile[i]) for i in range(3))
    pad = [grid[i] * tile[i] - out_shape[i] for i in range(3)]
    fpad = (0, pad[2], 0, pad[1], 0, pad[0])
    seg_p = F.pad(seg, fpad)
    bdry_p = F.pad(bdry_core, fpad)
    wins, bds = seg_p, bdry_p
    for ax in range(3):  # views (gx, gy, gz, wx, wy, wz) and (gx, gy, gz, tx, ty, tz)
        wins = wins.unfold(ax, tile[ax] + 2 * h[ax], tile[ax])
        bds = bds.unfold(ax, tile[ax], tile[ax])
    wins = wins.reshape((-1,) + tuple(wins.shape[3:]))
    bds = bds.reshape((-1,) + tuple(bds.shape[3:]))
    partners, overflow = [], []
    for t0 in range(0, wins.shape[0], _TILE_BATCH):
        p, o = _tile_kernel(wins[t0:t0 + _TILE_BATCH], bds[t0:t0 + _TILE_BATCH], stencil, K)
        partners.append(p)
        overflow.append(o)
    # core tiles do not overlap: reassembly is a reshape and a transpose
    out = torch.cat(partners).reshape(grid + tile + (2,)).permute(0, 3, 1, 4, 2, 5, 6)
    out = out.reshape(grid[0] * tile[0], grid[1] * tile[1], grid[2] * tile[2], 2)
    return (out[:out_shape[0], :out_shape[1], :out_shape[2]],
            torch.cat(overflow).reshape(grid))


def _pack(partners: np.ndarray) -> np.ndarray:
    """(…, 2) int32 (lo, hi) -> packed uint64, on the host: torch has no
    uint64 arithmetic to rely on."""
    return (partners[..., 0].astype(np.uint64) << np.uint64(32)) | partners[..., 1].astype(np.uint64)


def _patch_overflow_tiles(packed, overflow, seg, stencil, tile):
    """Recompute the overflowing tiles with the exact host kernel."""
    if not overflow.any():
        return packed
    from .contacts import detect_cs

    full = detect_cs(seg.astype(np.uint32), stencil=stencil)
    for gix in np.argwhere(overflow):
        sl = tuple(slice(g * t, min((g + 1) * t, packed.shape[d]))
                   for d, (g, t) in enumerate(zip(gix, tile)))
        packed[sl] = full[sl]
    return packed


def _check_labels(seg: np.ndarray) -> np.ndarray:
    seg = np.ascontiguousarray(seg)
    if seg.max(initial=0) >= 2**31:
        raise ValueError("the device formulations take labels < 2**31; "
                         "use ops.contacts.detect_cs")
    return seg


class _Pending:
    """A dispatched chunk: device work enqueued on the dispatcher's stream,
    results landing in pinned host memory; ``event`` fires when they have."""

    __slots__ = ("host", "event", "seg", "extra", "keep")

    def __init__(self, host, event, seg, extra, keep=None):
        self.host, self.event = host, event
        self.seg, self.extra, self.keep = seg, extra, keep

    def arrays(self):
        if self.event is not None:
            self.event.synchronize()
        return [t.numpy() for t in self.host]


class CsDispatcher:
    """Asynchronous dispatch/fetch around the device contact formulations,
    so that a caller overlaps the card's work with host post-processing.

    ``kernel``: ``"cuda"`` (the column formulation on the hand-written CUDA
    kernel; on a CPU device its plain version), ``"torch"`` (the per-tile
    formulation in tensor ops) or ``"auto"`` (``"cuda"`` on a CUDA device,
    ``"torch"`` on the CPU). ``device=None`` means the CUDA card (required).

    On a CUDA device ``dispatch`` enqueues upload, detection and download on
    the dispatcher's own stream, each handle with its own pinned buffers,
    and returns at once; ``fetch`` blocks on that handle's event.
    ``n_columns``/``n_overflow`` count the columns (or tiles) seen and those
    that went to the host kernel; ``prep_seconds``/``finish_seconds`` sum
    the host work before the upload and after the download.
    """

    def __init__(self, stencil=(13, 13, 7), tile=(32, 32, 16), K: int = 32,
                 kernel: str = "auto", device=None):
        self.device = default_device(device)
        self.stencil = tuple(int(s) for s in stencil)
        self.tile = tuple(int(t) for t in tile)
        self.K = int(K)
        if kernel == "auto":
            kernel = "cuda" if self.device.type == "cuda" else "torch"
        if kernel not in ("cuda", "torch"):
            raise ValueError(f"unknown cs kernel: {kernel!r}")
        self.kernel = kernel
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.n_columns = 0
        self.n_overflow = 0
        self.prep_seconds = 0.0
        self.finish_seconds = 0.0

    def _run(self, host_inputs, fn):
        """Upload ``host_inputs``, run ``fn`` on them, start the download;
        returns (pinned or plain host tensors, event or None, keep-alive)."""
        if self._stream is None:
            return [o.contiguous() for o in fn(*host_inputs)], None, None
        with torch.cuda.stream(self._stream):
            pinned = [t.pin_memory() for t in host_inputs]
            dev = [t.to(self.device, non_blocking=True) for t in pinned]
            outs = [o.contiguous() for o in fn(*dev)]
            host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs]
            for hbuf, o in zip(host, outs):
                hbuf.copy_(o, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return host, event, (pinned, dev, outs)

    def dispatch(self, seg: np.ndarray) -> _Pending:
        t0 = time.perf_counter()
        seg = _check_labels(seg)
        if self.kernel == "cuda":
            from .contacts_cuda import _columns_prep, detect_cs_columns

            tile_xy = self.tile[:2]
            seg_p, offs, cands, overflow, out_shape = _columns_prep(
                seg, self.stencil, tile_xy, self.K)
            self.prep_seconds += time.perf_counter() - t0
            host, event, keep = self._run(
                [torch.from_numpy(a) for a in (seg_p, offs, cands)],
                lambda s, o, c: detect_cs_columns(s, o, c, self.stencil, tile_xy))
            return _Pending(host, event, seg, (overflow, offs, out_shape), keep)
        self.prep_seconds += time.perf_counter() - t0
        host, event, keep = self._run(
            [torch.from_numpy(seg.astype(np.int32))],
            lambda s: detect_cs_device(s, self.stencil, self.tile, self.K))
        return _Pending(host, event, seg, None, keep)

    def fetch(self, handle: _Pending) -> np.ndarray:
        """Blocking: the chunk's packed uint64 contact segmentation."""
        if self.kernel == "cuda":
            from .contacts_cuda import _columns_finish

            overflow, offs, out_shape = handle.extra
            lo_t, hi_t = handle.arrays()
            t0 = time.perf_counter()
            packed = _columns_finish(handle.seg, lo_t, hi_t, overflow, offs, self.stencil,
                                     self.tile[:2], out_shape)
        else:
            partners, overflow = handle.arrays()
            t0 = time.perf_counter()
            packed = _patch_overflow_tiles(_pack(partners), overflow, handle.seg, self.stencil,
                                           self.tile)
        self.finish_seconds += time.perf_counter() - t0
        self.n_columns += overflow.size
        self.n_overflow += int(overflow.sum())
        return packed


class ResidentCsDetector:
    """Contact detection over a segmentation that lives in device memory:
    per-chunk windows are sliced on the device (no upload) and results come
    back sparse — contact voxels are a small share of a chunk, so the
    readback is (flat index, lo, hi) triples instead of a dense grid.

    ``seg_dev``: int32 (X, Y, Z) tensor (labels < 2**31) on its device. The
    volume is padded once to a chunk multiple plus the stencil halo. A chunk
    with more than ``cap = max(1024, prod(chunk) // cap_divisor)`` contact
    voxels is fetched densely.
    """

    def __init__(self, seg_dev: torch.Tensor, chunk: Sequence[int],
                 stencil: Sequence[int] = (13, 13, 7), tile: Sequence[int] = (32, 32, 16),
                 K: int = 32, cap_divisor: int = 8):
        self.stencil = tuple(int(s) for s in stencil)
        self.tile = tuple(int(t) for t in tile)
        self.K = int(K)
        self.chunk = tuple(int(c) for c in chunk)
        self.sh = tuple(int(s) for s in seg_dev.shape)
        self._h = h = tuple(s // 2 for s in self.stencil)
        self.grid = grid = tuple(-(-self.sh[i] // self.chunk[i]) for i in range(3))
        fpad = []
        for i in (2, 1, 0):
            fpad += [h[i], grid[i] * self.chunk[i] - self.sh[i] + h[i]]
        self._padded = F.pad(seg_dev.to(torch.int32), fpad)
        self.cap = max(1024, int(np.prod(self.chunk)) // int(cap_divisor))
        dev = self._padded.device
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        if self._stream is not None:  # the pad above ran on the current stream
            self._stream.wait_stream(torch.cuda.current_stream(dev))

    def _detect(self, cix):
        off = [int(cix[i]) * self.chunk[i] for i in range(3)]
        w = [self.chunk[i] + 2 * self._h[i] for i in range(3)]
        win = self._padded[off[0]:off[0] + w[0], off[1]:off[1] + w[1], off[2]:off[2] + w[2]]
        partners, overflow = detect_cs_device(win, self.stencil, self.tile, self.K)
        nz = partners[..., 0].reshape(-1) != 0
        return partners, overflow.any(), nz, nz.sum()

    def dispatch(self, cix):
        """Launch chunk (cx, cy, cz); returns a handle for :meth:`fetch`."""
        if self._stream is None:
            return (cix, self._detect(cix), None)
        with torch.cuda.stream(self._stream):
            res = self._detect(cix)
            event = torch.cuda.Event()
            event.record(self._stream)
        return (cix, res, event)

    def fetch(self, handle):
        """Blocking. Returns ``(packed, overflow)``: the chunk-core packed
        uint64 contact segmentation (cropped to the volume boundary) and a
        flag — True when a tile's candidate set overflowed K and the caller
        must recompute this chunk with the host kernel."""
        cix, (partners, overflow, nz, n), event = handle
        if event is not None:
            event.synchronize()
        n = int(n)
        core = tuple(min(self.chunk[i], self.sh[i] - int(cix[i]) * self.chunk[i])
                     for i in range(3))
        if n > self.cap:
            # denser than the compaction budget: dense fetch
            out = _pack(fetch(partners)).reshape(-1)
        else:
            out = np.zeros(int(np.prod(self.chunk)), np.uint64)
            if n > 0:
                idx = torch.nonzero(nz)[:, 0]
                out[fetch(idx)] = _pack(fetch(partners.reshape(-1, 2)[idx]))
        out = out.reshape(self.chunk)[:core[0], :core[1], :core[2]]
        return out, bool(overflow)


def detect_cs_torch(seg: np.ndarray, stencil=(13, 13, 7), tile=(32, 32, 16), K: int = 32,
                    device=None) -> np.ndarray:
    """Host wrapper of the per-tile formulation (the JAX package's
    ``detect_cs_tpu``): int label chunk (halo included) -> packed uint64
    contact segmentation of valid-convolution shape, equal to
    :func:`syconn_tpu_torch.ops.contacts.detect_cs`. Overflowing tiles are
    recomputed by the host kernel. ``device=None`` means the CUDA card."""
    device = default_device(device)
    seg = _check_labels(seg)
    stencil = tuple(int(s) for s in stencil)
    tile = tuple(int(t) for t in tile)
    partners, overflow = detect_cs_device(
        torch.from_numpy(seg.astype(np.int32)).to(device), stencil, tile, K)
    return _patch_overflow_tiles(_pack(partners.cpu().numpy()), overflow.cpu().numpy(), seg,
                                 stencil, tile)
