"""Tiled dense 3D CNN inference over chunked volumes (counterpart of
``syconn_tpu/inference/dense.py``).

The volume is covered by fixed-size tiles with a halo sized to the network's
receptive field; each tile is predicted on the card through the U-Net engine
(every 3x3x3 conv on the hand-written kernels), the halo cropped, and
per-class outputs written to target chunked volumes.

Execution model:
* a dispatch/fetch pipeline on one CUDA stream: a tile's upload (pinned
  memory), forward, softmax/threshold and download are enqueued without
  blocking, and the host waits only on that tile's download event, so the
  card computes tile i+1 while the host unpacks and writes tile i;
* host threads prefetch source tiles and write results;
* two output modes: ``probs`` (uint8 softmax probabilities) and ``masks``
  (thresholded on the card and bit-packed 1 bit/voxel along the patch
  voxels before the download, stored as 0/255).

On an out-of-memory error at the first dispatch, ``predict_dense_to_kd``
halves the largest tile axis and rebuilds (``shrink_tile_shape``).

When the source volume is held in device memory (``io.resident``),
``predict_dense_to_kd`` takes :class:`ResidentDensePredictor`: tiles are cut
from the padded device tensor and go through the engine ``tile_batch`` at a
time, the packed outputs come back in one transfer, and each class map is
reassembled on the device and registered in ``io.resident`` for the next
step (object extraction reads ``mi``/``vc`` from there).
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..io import resident
from ..io.chunked import ChunkedVolume
from ..models.convert import params_from_flax
from ..models.unet_engine import engine_supported, unet_apply_packed
from ..utils.device import default_device

log = logging.getLogger("syconn_tpu_torch.inference")

__all__ = ["DenseTilePredictor", "ResidentDensePredictor", "predict_dense_to_kd",
           "shrink_tile_shape"]


def _cdiv(a, b):
    return -(-a // b)


def _is_oom(e: Exception) -> bool:
    return isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in str(e)


def shrink_tile_shape(tile_shape, halo, patch):
    """Halve the largest tile axis (snapped to the model patch), shrinking
    the halo with it when needed. Returns (tile_shape, halo) or None when
    nothing can shrink further."""
    ts = np.asarray(tile_shape, np.int64).copy()
    h = np.asarray(halo, np.int64).copy()
    p = np.asarray(patch, np.int64)
    ax = int(np.argmax(ts))
    new = max(int(p[ax]), int(ts[ax] // 2 // p[ax] * p[ax]))
    if new == ts[ax]:
        return None
    ts[ax] = new
    h[ax] = min(int(h[ax]), new) // p[ax] * p[ax]
    return tuple(int(t) for t in ts), tuple(int(x) for x in h)


class _Pending:
    """A dispatched batch: device work enqueued, result landing in pinned
    host memory; ``event`` fires when the download is done."""

    __slots__ = ("host", "event", "keep")

    def __init__(self, host, event, keep):
        self.host, self.event, self.keep = host, event, keep


class DenseTilePredictor:
    """Tiled forward pass with a non-blocking dispatch/fetch pipeline.

    Output modes:
        * ``probs`` — (B, tx, ty, tz, C) uint8 softmax probabilities.
        * ``masks`` — (B, C, tx, ty, tz) 0/1, thresholded per class
          (``p >= threshold``) on the card and bit-packed for the download.

    ``model``/``params``: the port's :class:`UNet3D` and the flax params
    tree (as ``models.io.load_model`` returns them). ``device``: ``None``
    means the CUDA card (required); ``"cpu"`` runs the plain versions.
    """

    def __init__(self, model, params, tile_shape: Sequence[int] = (256, 256, 128),
                 halo: Sequence[int] = (32, 32, 16), batch_size: int = 1,
                 mode: str = "probs", thresholds: Optional[Sequence[float]] = None,
                 device=None):
        if not engine_supported(model):
            raise TypeError(f"the dense predictor runs UNet3D models, got {type(model).__name__}")
        if mode not in ("probs", "masks"):
            raise ValueError(f"unknown mode {mode!r}")
        self.device = default_device(device)
        self.model = model
        self.tile_shape = np.asarray(tile_shape, np.int64)
        self.halo = np.asarray(halo, np.int64)
        self.batch_size = int(batch_size)
        self.mode = mode
        self.patch = np.asarray(model.patch, np.int64)
        self._pvox = int(np.prod(self.patch))
        self._params = params_from_flax(params, self.device)
        n_classes = model.n_classes
        if thresholds is None:
            thresholds = [0.5] * n_classes
        self._thr = torch.tensor(np.asarray(thresholds, np.float32)[:, None],
                                 device=self.device)  # (C, 1)
        ts = tuple(int(t) for t in self.tile_shape)
        h = tuple(int(x) for x in self.halo)
        if not (np.all(self.tile_shape % self.patch == 0) and np.all(self.halo % self.patch == 0)):
            raise ValueError("tile_shape and halo must be divisible by the model patch "
                             f"(got {ts}, {h}, patch {tuple(self.patch)})")
        if (self._pvox * n_classes) % 8:
            raise ValueError("n_classes * patch voxels must be a multiple of 8")
        self._in_shape = (self.batch_size,) + tuple(np.add(ts, np.multiply(2, h)))
        self._bit_weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                                         device=self.device)

    @property
    def n_classes(self) -> int:
        return self.model.n_classes

    @torch.no_grad()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, X, Y, Z) uint8 on the device -> packed patched output."""
        tsp = self.tile_shape // self.patch
        hp = self.halo // self.patch
        lg = unet_apply_packed(self.model, self._params, x[..., None])
        lg = lg[:, hp[0]:hp[0] + tsp[0], hp[1]:hp[1] + tsp[1], hp[2]:hp[2] + tsp[2], :]
        b, sx, sy, sz, _ = lg.shape
        C = self.n_classes
        probs = torch.softmax(lg.reshape(b, sx, sy, sz, C, self._pvox), dim=-2)
        if self.mode == "probs":
            out = torch.round(probs * 255.0).to(torch.uint8)
            return out.reshape(b, sx, sy, sz, C * self._pvox)
        fg = (probs >= self._thr).reshape(b, sx, sy, sz, C * self._pvox // 8, 8)
        return (fg.to(torch.uint8) * self._bit_weights).sum(-1, dtype=torch.uint8)

    # ------------------------------------------------------------- pipeline
    def dispatch(self, x: np.ndarray):
        """Upload + launch + enqueue the download (non-blocking on CUDA)."""
        x = np.ascontiguousarray(x, dtype=np.uint8)
        if self.device.type == "cpu":
            return self._forward(torch.from_numpy(x)).numpy()
        xh = torch.from_numpy(x).pin_memory()
        out = self._forward(xh.to(self.device, non_blocking=True))
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return _Pending(host, ev, (xh, out))

    def fetch_raw(self, pending) -> np.ndarray:
        """Wait for a dispatched batch; returns the packed patched array."""
        if isinstance(pending, np.ndarray):
            return pending
        pending.event.synchronize()
        return pending.host.numpy().copy()

    def unpack(self, out: np.ndarray) -> np.ndarray:
        """Host depth-to-space of a packed patched array.

        Returns (B, X, Y, Z, C) uint8 probabilities (probs mode) or
        (B, C, X, Y, Z) uint8 0/1 masks (mask mode)."""
        b, sx, sy, sz, _ = out.shape
        C = self.n_classes
        px, py, pz = (int(p) for p in self.patch)
        if self.mode == "masks":
            out = np.unpackbits(out[..., None], axis=-1, bitorder="little")
        out = out.reshape(b, sx, sy, sz, C, px, py, pz)
        if self.mode == "masks":
            return np.ascontiguousarray(out.transpose(0, 4, 1, 5, 2, 6, 3, 7)).reshape(
                b, C, sx * px, sy * py, sz * pz)
        return np.ascontiguousarray(out.transpose(0, 1, 5, 2, 6, 3, 7, 4)).reshape(
            b, sx * px, sy * py, sz * pz, C)

    def fetch(self, pending) -> np.ndarray:
        return self.unpack(self.fetch_raw(pending))

    def predict_tiles(self, x: np.ndarray) -> np.ndarray:
        return self.fetch(self.dispatch(x))

    def predict_array(self, vol: np.ndarray) -> np.ndarray:
        """Predict a whole in-memory volume; returns (x, y, z, C) uint8 probs
        (probs mode) or (C, x, y, z) bool (mask mode)."""
        vol = np.asarray(vol, np.uint8)
        sh = np.array(vol.shape, np.int64)
        ts, h = self.tile_shape, self.halo
        grid = _cdiv(sh, ts)
        if self.mode == "probs":
            out = np.zeros(tuple(sh) + (self.n_classes,), np.uint8)
        else:
            out = np.zeros((self.n_classes,) + tuple(sh), bool)
        padded = np.pad(vol, [(h[i], h[i] + int(grid[i] * ts[i] - sh[i])) for i in range(3)])
        for gx in range(grid[0]):
            for gy in range(grid[1]):
                for gz in range(grid[2]):
                    o = np.array([gx, gy, gz]) * ts
                    tile = padded[o[0]:o[0] + ts[0] + 2 * h[0], o[1]:o[1] + ts[1] + 2 * h[1],
                                  o[2]:o[2] + ts[2] + 2 * h[2]]
                    res = self.predict_tiles(tile[None])[0]
                    hi = np.minimum(o + ts, sh)
                    s = hi - o
                    if self.mode == "probs":
                        out[o[0]:hi[0], o[1]:hi[1], o[2]:hi[2]] = res[:s[0], :s[1], :s[2]]
                    else:
                        out[:, o[0]:hi[0], o[1]:hi[1], o[2]:hi[2]] = res[:, :s[0], :s[1], :s[2]]
        return out


class ResidentDensePredictor(DenseTilePredictor):
    """Whole-volume variant: the volume is on the device once (a resident
    tensor is used where it is, a numpy volume uploaded); every tile is cut
    from the padded device tensor and ``tile_batch`` tiles go through the
    engine as one batch. The packed outputs stay on the device.

    On a device OOM the tile batch halves, down to 1. Environment override:
    ``SYCONN_TORCH_RESIDENT_TILE_BATCH``. ``n_forward`` counts the batches
    run.
    """

    def __init__(self, *a, tile_batch: int = 4, **kw):
        super().__init__(*a, **kw)
        tb = os.environ.get("SYCONN_TORCH_RESIDENT_TILE_BATCH")
        self.tile_batch = max(int(tb) if tb else int(tile_batch), 1)
        self.n_forward = 0

    @torch.no_grad()
    def _run(self, padded: torch.Tensor, grid, k: int) -> torch.Tensor:
        ts = [int(t) for t in self.tile_shape]
        win = [ts[i] + 2 * int(self.halo[i]) for i in range(3)]
        offs = [(gx * ts[0], gy * ts[1], gz * ts[2]) for gx in range(grid[0])
                for gy in range(grid[1]) for gz in range(grid[2])]
        n_tiles = len(offs)
        k = max(min(k, n_tiles), 1)
        # pad the offset list to a multiple of k with the last offset:
        # recomputed, then dropped from the output
        offs += [offs[-1]] * ((-n_tiles) % k)
        outs = []
        for g in range(0, len(offs), k):
            wins = torch.stack([padded[o[0]:o[0] + win[0], o[1]:o[1] + win[1],
                                       o[2]:o[2] + win[2]] for o in offs[g:g + k]])
            outs.append(self._forward(wins))
            self.n_forward += 1
        return torch.cat(outs)[:n_tiles]

    def predict_volume_packed(self, vol):
        """vol (X, Y, Z) uint8, numpy or a device tensor -> (packed tiles
        (T, sx, sy, sz, C * pvox) on the device, tile grid)."""
        sh = np.array(vol.shape, np.int64)
        ts, h = self.tile_shape, self.halo
        grid = tuple(int(g) for g in _cdiv(sh, ts))
        pad = [(int(h[i]), int(grid[i] * ts[i] - sh[i] + h[i])) for i in range(3)]
        if isinstance(vol, np.ndarray):
            padded = torch.from_numpy(np.pad(vol.astype(np.uint8, copy=False), pad)).to(
                self.device)
        else:
            padded = F.pad(vol.to(self.device, torch.uint8),
                           (pad[2][0], pad[2][1], pad[1][0], pad[1][1], pad[0][0], pad[0][1]))
        tb = self.tile_batch
        while True:
            try:
                out = self._run(padded, grid, tb)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)  # surface an OOM here
                return out, grid
            except RuntimeError as e:
                if tb <= 1 or not _is_oom(e):
                    raise
                tb = max(tb // 2, 1)
                self.tile_batch = tb
                torch.cuda.empty_cache()
                log.warning("resident tile batch OOM; retrying with tile_batch=%d", tb)

    @torch.no_grad()
    def class_volume_device(self, packed: torch.Tensor, grid, ch: int, out_shape) -> torch.Tensor:
        """One class' full volume from the packed tile stack, on the device:
        (T, sx, sy, sz, C * pvox) -> (X, Y, Z) uint8 (probs: probabilities;
        masks: 0/255)."""
        t, sx, sy, sz, _ = packed.shape
        C = self.n_classes
        px, py, pz = (int(p) for p in self.patch)
        if self.mode == "masks":
            shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
            packed = (packed[..., None] >> shifts) & 1
        one = packed.reshape(t, sx, sy, sz, C, px * py * pz)[:, :, :, :, ch, :]
        # patched -> full resolution (depth-to-space), then tile grid -> volume
        one = one.reshape(t, sx, sy, sz, px, py, pz).permute(0, 1, 4, 2, 5, 3, 6)
        v = one.reshape(tuple(grid) + (sx * px, sy * py, sz * pz)).permute(0, 3, 1, 4, 2, 5)
        v = v.reshape(grid[0] * sx * px, grid[1] * sy * py, grid[2] * sz * pz)
        v = v[:out_shape[0], :out_shape[1], :out_shape[2]].contiguous()
        return v * 255 if self.mode == "masks" else v


def predict_dense_to_kd(
    kd_path: str,
    target_paths: Dict[str, str],
    model,
    params,
    channel_mapping: Dict[str, int],
    mag: int = 1,
    tile_shape: Sequence[int] = (256, 256, 128),
    halo: Sequence[int] = (32, 32, 16),
    seg_path: Optional[str] = None,
    target_mags: Sequence[int] = (1, 2),
    io_threads: int = 8,
    show_progress: bool = True,
    mode: str = "probs",
    thresholds: Optional[Sequence[float]] = None,
    pipeline_depth: int = 2,
    predictor: Optional[DenseTilePredictor] = None,
    batch_size: int = 1,
    device=None,
) -> dict:
    """Predict a whole chunked volume and write per-class outputs.

    Args:
        kd_path: source volume ('raw' channel is read at ``mag``).
        target_paths: output name -> target volume path (created).
        channel_mapping: output name -> class channel index.
        seg_path: optional argmax label volume output (probs mode only).
        mode/thresholds: see :class:`DenseTilePredictor`.
        device: ``None`` = the CUDA card; ``"cpu"`` for the plain versions.

    A source whose 'raw' channel at ``mag`` is held by ``io.resident`` runs
    through :class:`ResidentDensePredictor` when no ``predictor`` is given
    (see :func:`_predict_resident`).

    Returns timing/throughput stats; ``dispatches`` counts forward passes
    (the first-dispatch probe included), ``route`` is ``"stream"`` or
    ``"resident"``.
    """
    src = ChunkedVolume.open(kd_path)
    res_src = resident.get(kd_path, "raw", mag) if predictor is None else None
    n_dispatch = 0
    if predictor is not None:
        pred = predictor
    else:
        # OOM-adaptive tile sizing: try the requested tile; on a device OOM
        # at the first dispatch halve the largest axis and retry
        pred_cls = ResidentDensePredictor if res_src is not None else DenseTilePredictor
        while True:
            pred = pred_cls(model, params, tile_shape=tile_shape, halo=halo, mode=mode,
                            thresholds=thresholds, batch_size=batch_size, device=device)
            try:
                warm = np.zeros((pred.batch_size,) + pred._in_shape[1:], np.uint8)
                n_dispatch += 1
                pred.fetch_raw(pred.dispatch(warm))
                break
            except Exception as e:
                if not _is_oom(e):
                    raise
                shrunk = shrink_tile_shape(tile_shape, halo, pred.patch)
                if shrunk is None:
                    raise
                del pred
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
                log.warning("device OOM at tile %s; retrying with tile %s halo %s",
                            tuple(tile_shape), *shrunk)
                tile_shape, halo = shrunk
    sh = src.mag_shape(mag)
    ts = np.asarray(tile_shape, np.int64)
    h = np.asarray(halo, np.int64)
    grid = _cdiv(sh, ts)
    scale = src.scale * mag

    def create(path):
        return ChunkedVolume.create(path, scale=scale, boundary=sh,
                                    experiment_name=src.experiment_name,
                                    chunk_shape=tuple(int(t) for t in ts))

    targets = {name: create(path) for name, path in target_paths.items()}
    seg_kd = None
    if seg_path is not None:
        if mode != "probs":
            raise ValueError("seg output requires probs mode")
        seg_kd = create(seg_path)

    if isinstance(pred, ResidentDensePredictor):
        return _predict_resident(pred, src, res_src, targets, seg_kd, target_paths,
                                 channel_mapping, mag, target_mags, io_threads, n_dispatch,
                                 model, params, thresholds, batch_size)

    tiles = [np.array([gx, gy, gz]) * ts for gx in range(grid[0])
             for gy in range(grid[1]) for gz in range(grid[2])]

    def load_tile(offset):
        return src.load_raw(offset=offset - h, size=ts + 2 * h, mag=mag)

    def unpack_and_write(offset, res):
        """Chunk writes of one unpacked tile (runs in a writer thread)."""
        hi = np.minimum(offset + ts, sh)
        s = hi - offset
        for name, ch in channel_mapping.items():
            if name not in targets:
                continue
            if mode == "probs":
                data = np.ascontiguousarray(res[:s[0], :s[1], :s[2], ch])
                targets[name].save_raw(data, offset, target_mags)
            else:
                data = res[ch, :s[0], :s[1], :s[2]] * np.uint8(255)
                targets[name].save_raw(data, offset, target_mags, downsample="stride")
        if seg_kd is not None:
            labels = np.argmax(res[:s[0], :s[1], :s[2]], axis=-1).astype(np.uint64)
            seg_kd.save_seg(labels, offset, target_mags)

    def unpack_batch_and_write(batch_ixs, raw):
        res = pred.unpack(raw)
        for k, ti in enumerate(batch_ixs):
            unpack_and_write(tiles[ti], res[k])

    batch = max(1, int(pred.batch_size))
    writer = ThreadPoolExecutor(max_workers=io_threads)
    loader = ThreadPoolExecutor(max_workers=io_threads)
    t0 = time.perf_counter()
    n_vox = 0
    # host prefetch -> device dispatch -> host unpack + write
    batches = [list(range(i, min(i + batch, len(tiles)))) for i in range(0, len(tiles), batch)]
    prefetch_depth = pipeline_depth + 2
    load_futs = {bi: [loader.submit(load_tile, tiles[i]) for i in batches[bi]]
                 for bi in range(min(prefetch_depth, len(batches)))}
    inflight: deque = deque()
    write_futs = []

    def drain_one():
        nonlocal n_vox
        bi, pending = inflight.popleft()
        raw = pred.fetch_raw(pending)
        write_futs.append(writer.submit(unpack_batch_and_write, batches[bi], raw))
        for i in batches[bi]:
            n_vox += int(np.prod(np.minimum(tiles[i] + ts, sh) - tiles[i]))

    try:
        for bi in range(len(batches)):
            data = np.stack([f.result() for f in load_futs.pop(bi)])
            if len(data) < batch:
                pad = np.zeros((batch - len(data),) + data.shape[1:], data.dtype)
                data = np.concatenate([data, pad])
            nxt = bi + prefetch_depth
            if nxt < len(batches):
                load_futs[nxt] = [loader.submit(load_tile, tiles[i]) for i in batches[nxt]]
            inflight.append((bi, pred.dispatch(data)))
            n_dispatch += 1
            while len(inflight) > pipeline_depth:
                drain_one()
            if show_progress and (bi + 1) % 16 == 0:
                log.info("dense prediction: %d/%d batches dispatched", bi + 1, len(batches))
        while inflight:
            drain_one()
        for f in write_futs:
            f.result()
    finally:
        writer.shutdown()
        loader.shutdown()
    dt = time.perf_counter() - t0
    stats = {"n_voxels": n_vox, "seconds": dt, "mvox_per_s": n_vox / dt / 1e6,
             "tiles": len(tiles), "dispatches": n_dispatch, "route": "stream",
             "tile_shape": [int(t) for t in ts], "halo": [int(x) for x in h]}
    log.info("dense prediction done: %.1f MVx in %.1f s (%.1f MVx/s)",
             n_vox / 1e6, dt, stats["mvox_per_s"])
    return stats


def _packed_tile_bytes(pred: DenseTilePredictor) -> int:
    """Device bytes of one tile's packed output as the JAX package counts
    them: the minor dimension (C * patch voxels) rounded up to XLA's 128
    lanes. The port's tensors have no lane padding; the rule is kept so that
    both packages cut the same z-slabs."""
    dims = [int(pred.tile_shape[i]) // int(pred.patch[i]) for i in range(3)]
    lane = -(-int(pred.n_classes * np.prod(pred.patch)) // 128) * 128
    return int(np.prod(dims)) * lane


def _predict_resident(pred, src, res_src, targets, seg_kd, target_paths, channel_mapping, mag,
                      target_mags, io_threads, n_dispatch, model, params, thresholds, batch_size):
    """The resident branch of :func:`predict_dense_to_kd`.

    The volume (resident, else loaded whole) is predicted in z-slabs when
    the packed output of all its tiles would exceed 2 GiB; slab seams then
    see a zero halo, as at the volume border. A device OOM shrinks the tile
    and rebuilds the predictor. With one slab and a resident source at mag
    1, each class map is reassembled on the device and registered in
    ``io.resident`` under its target path; an OOM there skips the
    registration (logged), and consumers read the chunk store instead.
    """
    mode = pred.mode
    sh = src.mag_shape(mag)
    t0 = time.perf_counter()
    vol = res_src if res_src is not None else src.load_raw(offset=(0, 0, 0), size=sh, mag=mag)
    n_forward = 0
    while True:
        ts, h = pred.tile_shape, pred.halo
        try:
            grid_all = tuple(int(g) for g in _cdiv(sh, ts))
            layers = max(1, min(grid_all[2], (2 << 30) // max(
                _packed_tile_bytes(pred) * grid_all[0] * grid_all[1], 1)))
            if layers < grid_all[2]:
                log.info("resident prediction in %d z-slabs of %d tile layers",
                         -(-grid_all[2] // layers), layers)
            multi = layers < grid_all[2]
            z_step = int(layers * ts[2])
            packed_parts = []
            for z0 in range(0, int(sh[2]), z_step):
                packed, grid_s = pred.predict_volume_packed(vol[:, :, z0:min(z0 + z_step,
                                                                              int(sh[2]))])
                # several slabs: drain each to the host before the next
                packed_parts.append((z0, packed.cpu().numpy() if multi else packed, grid_s))
                del packed
            break
        except RuntimeError as e:
            if not _is_oom(e):
                raise
            shrunk = shrink_tile_shape(tuple(int(t) for t in ts), tuple(int(x) for x in h),
                                       pred.patch)
            if shrunk is None:
                raise
            log.warning("resident forward OOM; retrying with tile %s halo %s", *shrunk)
            n_forward += pred.n_forward
            device = pred.device
            del pred
            torch.cuda.empty_cache()
            pred = ResidentDensePredictor(model, params, tile_shape=shrunk[0], halo=shrunk[1],
                                          mode=mode, thresholds=thresholds,
                                          batch_size=batch_size, device=device)
    ts = pred.tile_shape
    registered = []
    if mag == 1 and res_src is not None and len(packed_parts) == 1:
        _, packed, grid_r = packed_parts[0]
        for name, ch in channel_mapping.items():
            if name not in target_paths:
                continue
            try:
                cls_vol = pred.class_volume_device(packed, grid_r, int(ch),
                                                   tuple(int(x) for x in sh))
            except RuntimeError as e:
                if not _is_oom(e):
                    raise
                log.warning("skipping resident registration of %s output (device "
                            "reassembly OOM: %.80s)", name, str(e))
                break
            if resident.put(target_paths[name], "raw", cls_vol, mag=mag):
                registered.append(name)
            del cls_vol

    def write_one(offset, packed_tile):
        res = pred.unpack(packed_tile[None])[0]
        s = np.minimum(offset + ts, sh) - offset
        for name, ch in channel_mapping.items():
            if name not in targets:
                continue
            if mode == "probs":
                targets[name].save_raw(np.ascontiguousarray(res[:s[0], :s[1], :s[2], ch]),
                                       offset, target_mags)
            else:
                targets[name].save_raw(res[ch, :s[0], :s[1], :s[2]] * np.uint8(255), offset,
                                       target_mags, downsample="stride")
        if seg_kd is not None:
            labels = np.argmax(res[:s[0], :s[1], :s[2]], axis=-1).astype(np.uint64)
            seg_kd.save_seg(labels, offset, target_mags)

    n_tiles = 0
    with ThreadPoolExecutor(max_workers=io_threads) as writer:
        futs = []
        for z_base, packed, grid_r in packed_parts:
            packed = packed if isinstance(packed, np.ndarray) else packed.cpu().numpy()
            k = 0
            for gx in range(grid_r[0]):
                for gy in range(grid_r[1]):
                    for gz in range(grid_r[2]):
                        off = np.array([gx, gy, gz]) * ts
                        off[2] += z_base
                        futs.append(writer.submit(write_one, off, packed[k]))
                        k += 1
            n_tiles += k
        for f in futs:
            f.result()
    dt = time.perf_counter() - t0
    n_vox = int(np.prod(sh))
    stats = {"n_voxels": n_vox, "seconds": dt, "mvox_per_s": n_vox / dt / 1e6,
             "tiles": n_tiles, "dispatches": n_dispatch + n_forward + pred.n_forward,
             "route": "resident", "tile_batch": pred.tile_batch, "slabs": len(packed_parts),
             "registered": registered, "tile_shape": [int(t) for t in ts],
             "halo": [int(x) for x in pred.halo]}
    log.info("dense prediction (resident) done: %.1f MVx in %.1f s (%.1f MVx/s)",
             n_vox / 1e6, dt, stats["mvox_per_s"])
    return stats
