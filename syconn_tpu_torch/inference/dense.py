"""Tiled dense 3D CNN inference over chunked volumes (counterpart of
``syconn_tpu/inference/dense.py``).

The volume is covered by fixed-size tiles with a halo sized to the network's
receptive field; each tile is predicted on the card through the U-Net engine
(every 3x3x3 conv on the hand-written kernels), the halo cropped, and
per-class outputs written to target chunked volumes.

Execution model:
* a dispatch/fetch pipeline on one CUDA stream: a tile's upload (pinned
  memory), forward, head and download are enqueued without blocking, and
  the host waits only on that tile's download event, so the card computes
  tile i+1 while the host unpacks and writes tile i;
* the head after the engine (crop of the halo, class softmax, quantise or
  threshold and bit-pack) is one kernel on the card (``ops.head``), which
  reads each cropped logit once;
* host threads prefetch source tiles and write results;
* two output modes: ``probs`` (uint8 softmax probabilities) and ``masks``
  (thresholded on the card and bit-packed 1 bit/voxel along the patch
  voxels before the download, stored as 0/255);
* probability maps wanted at mag 2 are pooled to it on the card
  (``ops.pool.pool_mag2``, the chunk store's mean to the byte) and
  downloaded beside the mag-1 maps (stream route), not pooled by the
  writer threads.

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

import contextlib
import functools
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
from ..models import nnunet_engine, unet_engine
from ..models.convert import params_from_flax
from ..ops.head import dense_head
from ..ops.pool import pool_mag2
from ..parallel.device import canonical_device, data_sharding, gather, on_device, place
from ..parallel.sharded import mesh_from_config
from ..utils import tracing
from ..utils.device import default_device

log = logging.getLogger("syconn_tpu_torch.inference")

__all__ = ["DenseTilePredictor", "ResidentDensePredictor", "engine_of", "predict_dense_to_kd",
           "shrink_tile_shape"]


def _cdiv(a, b):
    return -(-a // b)


def _is_oom(e: Exception) -> bool:
    return isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in str(e)


def engine_of(model):
    """The model's engine: (``prepare(params, device)``, the engine's
    parameters on a device from the params the predictor was given;
    ``apply(model, engine_params, x)``, x (B, X, Y, Z, 1) uint8 on that device
    -> packed f32 logits (B, X/px, Y/py, Z/pz, n_classes * pvox)).

    :class:`~..models.unet3d.UNet3D` takes a flax params tree
    (``params_from_flax``, ``unet_apply_packed``);
    :class:`~..models.nnunet.NNUNet` its flat PyTorch-layout dict
    (``models/nnunet_engine.py``)."""
    if unet_engine.engine_supported(model):
        return params_from_flax, unet_engine.unet_apply_packed
    if nnunet_engine.engine_supported(model):
        return nnunet_engine.device_params, nnunet_engine.nnunet_apply_packed
    raise TypeError(f"the dense predictor runs UNet3D and NNUNet models, got "
                    f"{type(model).__name__}")


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
    """A dispatched batch: device work enqueued, result (and the mag-2 maps,
    where asked for) landing in pinned host memory; ``event`` fires when the
    downloads are done."""

    __slots__ = ("host", "pooled", "event", "keep")

    def __init__(self, host, pooled, event, keep):
        self.host, self.pooled, self.event, self.keep = host, pooled, event, keep


class DenseTilePredictor:
    """Tiled forward pass with a non-blocking dispatch/fetch pipeline.

    Output modes:
        * ``probs`` — (B, tx, ty, tz, C) uint8 softmax probabilities.
        * ``masks`` — (B, C, tx, ty, tz) 0/1, thresholded per class
          (``p >= threshold``) on the card and bit-packed for the download.

    ``model``/``params``: the port's :class:`UNet3D` and the flax params
    tree (as ``models.io.load_model`` returns them), or an
    :class:`~..models.nnunet.NNUNet` and its flat dict of arrays (see
    :func:`engine_of`). ``device``: ``None`` means the CUDA card (required);
    ``"cpu"`` runs the plain versions.

    ``mesh``: a ``parallel.device.DeviceMesh`` with a ``data`` axis: each
    batch splits over it, every data position runs its slice through the
    engine on its own device (params converted once per distinct device)
    and the outputs are gathered in mesh order on ``device``.
    ``batch_size`` is rounded up to a multiple of the axis. Per-tile
    arithmetic is unchanged, so the outputs equal the single-device path's.
    """

    def __init__(self, model, params, tile_shape: Sequence[int] = (256, 256, 128),
                 halo: Sequence[int] = (32, 32, 16), batch_size: int = 1,
                 mode: str = "probs", thresholds: Optional[Sequence[float]] = None,
                 device=None, mesh=None):
        prepare, self._apply = engine_of(model)
        if mode not in ("probs", "masks"):
            raise ValueError(f"unknown mode {mode!r}")
        self.device = default_device(device)
        self.model = model
        self.mesh = mesh
        self.tile_shape = np.asarray(tile_shape, np.int64)
        self.halo = np.asarray(halo, np.int64)
        # the devices that run the forward: the data axis' positions, or
        # the predictor's own device
        home = canonical_device(self.device)
        self._replicas = [home] if mesh is None else mesh.axis_devices("data")
        n_data = len(self._replicas)
        self.batch_size = _cdiv(int(batch_size), n_data) * n_data
        self.mode = mode
        self.patch = np.asarray(model.patch, np.int64)
        self._pvox = int(np.prod(self.patch))
        n_classes = model.n_classes
        if thresholds is None:
            thresholds = [0.5] * n_classes
        thr = torch.tensor(np.asarray(thresholds, np.float32)[:, None])  # (C, 1)
        bits = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8)
        # engine params, thresholds and bit weights once per distinct device
        self._on = {}
        with tracing.span("predictor.build", replicas=n_data):
            for d in dict.fromkeys(self._replicas + [home]):
                self._on[d] = (prepare(params, d), place(thr, d), place(bits, d))
        self._home = home
        ts = tuple(int(t) for t in self.tile_shape)
        h = tuple(int(x) for x in self.halo)
        if not (np.all(self.tile_shape % self.patch == 0) and np.all(self.halo % self.patch == 0)):
            raise ValueError("tile_shape and halo must be divisible by the model patch "
                             f"(got {ts}, {h}, patch {tuple(self.patch)})")
        if (self._pvox * n_classes) % (8 if mode == "masks" else 4):
            raise ValueError("n_classes * patch voxels must be a multiple of 4 (probs) or of 8 "
                             "(masks)")
        self._in_shape = (self.batch_size,) + tuple(np.add(ts, np.multiply(2, h)))

    @property
    def n_classes(self) -> int:
        return self.model.n_classes

    @torch.no_grad()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, X, Y, Z) uint8 on the device -> packed patched output. With
        a mesh, B splits over the data axis and the replicas' outputs are
        gathered in mesh order on the predictor's device."""
        if self.mesh is None:
            return self._forward_on(x, *self._on[self._home])
        outs = []
        for xs in data_sharding(x, self.mesh, "data"):
            with on_device(xs.device):
                outs.append(self._forward_on(xs, *self._on[xs.device]))
        return gather(outs, self.device)

    def _forward_on(self, x: torch.Tensor, params: dict, thr: torch.Tensor,
                    bit_weights: torch.Tensor) -> torch.Tensor:
        """One device's forward; ``params``, ``thr``, ``bit_weights`` on x's
        device. The head (crop, class softmax, quantise or threshold and
        bit-pack) is ``ops.head.dense_head``: one kernel on the card, its
        plain version on the CPU."""
        tsp = self.tile_shape // self.patch
        hp = self.halo // self.patch
        b = int(x.shape[0])
        with tracing.span("engine.forward", device=x.device, batch=b):
            lg = self._apply(self.model, params, x[..., None])
        # the kernel sets fused_tiles to the tiles it took
        with tracing.span("engine.head", device=x.device, batch=b, fused_tiles=0):
            return dense_head(lg, hp, tsp, self.n_classes, self._pvox, self.mode, thr,
                              bit_weights)

    # ------------------------------------------------------------- pipeline
    def dispatch(self, x: np.ndarray, extents=None, classes: Optional[Sequence[int]] = None):
        """Upload + launch + enqueue the download (non-blocking on CUDA).

        With ``extents`` ((B, 3): each row's crop extent inside the volume,
        0 for a row that only pads the batch; probs mode), the maps of
        ``classes`` (default all) are also pooled to mag 2 on the device
        (``ops.pool.pool_mag2``: the chunk store's edge-padded mean, to the
        byte) and downloaded beside the packed output."""
        x = np.ascontiguousarray(x, dtype=np.uint8)
        if self.device.type == "cpu":
            out = self._forward(torch.from_numpy(x))
            if extents is None:
                return out.numpy()
            return out.numpy(), self._pool(out, extents, classes).numpy()
        xh = torch.from_numpy(x).pin_memory()
        out = self._forward(xh.to(self.device, non_blocking=True))
        pooled = host2 = None
        if extents is not None:
            pooled = self._pool(out, extents, classes)
            host2 = torch.empty(pooled.shape, dtype=pooled.dtype, pin_memory=True)
            host2.copy_(pooled, non_blocking=True)
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return _Pending(host, host2, ev, (xh, out, pooled))

    def _pool(self, out: torch.Tensor, extents, classes) -> torch.Tensor:
        if self.mode != "probs":
            raise ValueError("mag-2 pooling takes probs mode")
        ext = np.asarray(extents, np.int64)
        live = ext.min(axis=1) > 0
        n_cls = self.n_classes if classes is None else len(classes)
        voxels = int(np.prod(-(-ext[live] // 2), axis=1).sum()) * n_cls
        with tracing.span("dense.pool", device=out.device, tiles=int(live.sum()), voxels=voxels):
            return pool_mag2(out, ext, self.patch, self.n_classes, classes)

    def fetch_raw(self, pending):
        """Wait for a dispatched batch; returns the packed patched array, and
        with it the mag-2 maps where :meth:`dispatch` was given extents."""
        if isinstance(pending, (np.ndarray, tuple)):
            return pending
        pending.event.synchronize()
        raw = pending.host.numpy().copy()
        return raw if pending.pooled is None else (raw, pending.pooled.numpy().copy())

    @tracing.traced("dense.unpack")
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

    On a device OOM the tile batch halves, down to 1 (with a mesh: to the
    data axis' size). Environment override:
    ``SYCONN_TORCH_RESIDENT_TILE_BATCH``. With a mesh the tile batch is
    rounded up to a multiple of the data axis, and each batch splits over
    it. ``n_forward`` counts the batches run.
    """

    def __init__(self, *a, tile_batch: int = 4, **kw):
        super().__init__(*a, **kw)
        tb = os.environ.get("SYCONN_TORCH_RESIDENT_TILE_BATCH")
        n_data = len(self._replicas)
        self.tile_batch = _cdiv(max(int(tb) if tb else int(tile_batch), 1), n_data) * n_data
        self.n_forward = 0

    @torch.no_grad()
    def _run(self, padded: torch.Tensor, grid, k: int) -> torch.Tensor:
        ts = [int(t) for t in self.tile_shape]
        win = [ts[i] + 2 * int(self.halo[i]) for i in range(3)]
        offs = [(gx * ts[0], gy * ts[1], gz * ts[2]) for gx in range(grid[0])
                for gy in range(grid[1]) for gz in range(grid[2])]
        n_tiles = len(offs)
        n_data = len(self._replicas)
        k = max(min(k, _cdiv(n_tiles, n_data) * n_data), n_data)
        # pad the offset list to a multiple of k with the last offset:
        # recomputed, then dropped from the output
        offs += [offs[-1]] * ((-n_tiles) % k)
        outs = []
        for g in range(0, len(offs), k):
            with tracing.span("resident.stack", device=padded.device, tiles=k):
                wins = torch.stack([padded[o[0]:o[0] + win[0], o[1]:o[1] + win[1],
                                           o[2]:o[2] + win[2]] for o in offs[g:g + k]])
            outs.append(self._forward(wins))
            self.n_forward += 1
        with tracing.span("resident.concat", device=self.device, tiles=n_tiles):
            return torch.cat(outs)[:n_tiles]

    @tracing.traced("resident.predict")
    def predict_volume_packed(self, vol):
        """vol (X, Y, Z) uint8, numpy or a device tensor -> (packed tiles
        (T, sx, sy, sz, C * pvox) on the device, tile grid)."""
        sh = np.array(vol.shape, np.int64)
        ts, h = self.tile_shape, self.halo
        grid = tuple(int(g) for g in _cdiv(sh, ts))
        tracing.annotate(tiles=int(np.prod(grid)))
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
                n_data = len(self._replicas)
                if tb <= n_data or not _is_oom(e):
                    raise
                tb = max(tb // 2 // n_data * n_data, n_data)
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
        with tracing.span("resident.reassembly", device=packed.device, channel=int(ch)):
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


@tracing.traced("dense.predict")
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
    mesh=None,
) -> dict:
    """Predict a whole chunked volume and write per-class outputs.

    Args:
        kd_path: source volume ('raw' channel is read at ``mag``).
        target_paths: output name -> target volume path (created).
        channel_mapping: output name -> class channel index.
        seg_path: optional argmax label volume output (probs mode only).
        mode/thresholds: see :class:`DenseTilePredictor`.
        device: ``None`` = the CUDA card; ``"cpu"`` for the plain versions.
        mesh: a device mesh with a ``data`` axis the batches split over
            (see :class:`DenseTilePredictor`); without ``predictor`` and a
            resident source it defaults to
            ``parallel.sharded.mesh_from_config(axis_name="data")`` (None on
            one card).

    A source whose 'raw' channel at ``mag`` is held by ``io.resident`` runs
    through :class:`ResidentDensePredictor` when no ``predictor`` is given
    (see :func:`_predict_resident`), else the tiles stream from the store
    (:func:`_predict_stream`). A given ``predictor`` sets the route, mode,
    device and mesh.

    Returns timing/throughput stats; ``dispatches`` counts forward passes
    (the first-dispatch probe included), ``route`` is ``"stream"`` or
    ``"resident"``.
    """
    src = ChunkedVolume.open(kd_path)
    res_src = resident.get(kd_path, "raw", mag) if predictor is None else None
    if predictor is not None:
        pred_cls = type(predictor)
        mode, device, mesh = predictor.mode, predictor.device, predictor.mesh
    else:
        pred_cls = ResidentDensePredictor if res_src is not None else DenseTilePredictor
        if mesh is None and res_src is None:
            mesh = mesh_from_config(axis_name="data", device=default_device(device))
    # every argument but the tile: the first-dispatch probe and the resident
    # route's OOM rebuild make their predictors with it
    new_predictor = functools.partial(pred_cls, model, params, mode=mode, thresholds=thresholds,
                                      batch_size=batch_size, device=device, mesh=mesh)
    pred, n_dispatch = ((predictor, 0) if predictor is not None
                        else _probed_predictor(new_predictor, tile_shape, halo))
    sh = src.mag_shape(mag)
    scale = src.scale * mag

    def create(path):
        return ChunkedVolume.create(path, scale=scale, boundary=sh,
                                    experiment_name=src.experiment_name,
                                    chunk_shape=tuple(int(t) for t in pred.tile_shape))

    targets = {name: create(path) for name, path in target_paths.items()}
    seg_kd = None
    if seg_path is not None:
        if mode != "probs":
            raise ValueError("seg output requires probs mode")
        seg_kd = create(seg_path)
    mapped = [(name, ch) for name, ch in channel_mapping.items() if name in targets]
    writer = _TileWriter(targets, mapped, seg_kd, mode, target_mags, sh)

    tracing.annotate(route="resident" if isinstance(pred, ResidentDensePredictor) else "stream")
    if isinstance(pred, ResidentDensePredictor):
        return _predict_resident(pred, new_predictor, writer, src, res_src, mag, io_threads,
                                 n_dispatch)
    return _predict_stream(pred, writer, src, mag, io_threads, pipeline_depth, show_progress,
                           n_dispatch)


def _probed_predictor(new_predictor, tile_shape, halo):
    """``new_predictor(tile_shape, halo)`` after one dispatch of zeros went
    through it; on a device OOM there the largest tile axis halves
    (:func:`shrink_tile_shape`) and the predictor is made again. Returns the
    predictor and the dispatches run."""
    n_dispatch = 0
    while True:
        pred = new_predictor(tile_shape, halo)
        try:
            warm = np.zeros((pred.batch_size,) + pred._in_shape[1:], np.uint8)
            n_dispatch += 1
            pred.fetch_raw(pred.dispatch(warm))
            return pred, n_dispatch
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


class _TileWriter:
    """The chunk writes of :func:`predict_dense_to_kd`'s unpacked tiles,
    for both routes.

    Each mapped class (``mapped``: (name, channel) in ``channel_mapping``
    order) is cropped to the volume and written to its target at
    ``target_mags``: probabilities as they are, the chunk store pooling the
    mags above 1 by its mean; masks as 0/255, by its stride view; and into
    ``seg_kd``, where given, the argmax labels. Where the stream route pooled
    the maps to mag 2 on the device (:meth:`pools_on_device`), mag 2 is
    written from those and the chunk store pools only the other mags.
    """

    def __init__(self, targets: Dict[str, ChunkedVolume], mapped, seg_kd: Optional[ChunkedVolume],
                 mode: str, target_mags: Sequence[int], volume_shape):
        self.targets, self.mapped, self.seg_kd = targets, mapped, seg_kd
        self.mode, self.target_mags = mode, tuple(target_mags)
        self.mags_but_2 = tuple(m for m in self.target_mags if m != 2)
        self.volume_shape = np.asarray(volume_shape, np.int64)

    def pools_on_device(self, tile_shape) -> bool:
        """Whether the maps come down pooled to mag 2: probability maps wanted
        at mag 2, from tiles at even offsets (the chunk store refuses a mag-2
        write at an odd one)."""
        return (self.mode == "probs" and 2 in self.target_mags and bool(self.mapped)
                and not np.any(np.asarray(tile_shape) % 2))

    def assembling(self) -> contextlib.ExitStack:
        """The targets' ``assembling`` contexts as one: each chunk that
        several tiles' pieces make up (the mag-2 levels, edge chunks) is
        written once, and every chunk is on disk when the context ends."""
        stack = contextlib.ExitStack()
        for v in [*self.targets.values(), self.seg_kd]:
            if v is not None:
                stack.enter_context(v.assembling())
        return stack

    def write(self, offset, res: np.ndarray, pooled: Optional[np.ndarray] = None) -> None:
        """Write one tile at ``offset`` (its corner in the volume): ``res`` as
        :meth:`DenseTilePredictor.unpack` gives one, (X, Y, Z, C)
        probabilities or (C, X, Y, Z) 0/1 masks; ``pooled`` its (K, ...)
        mag-2 maps of the mapped classes, or None."""
        tile = res.shape[:3] if self.mode == "probs" else res.shape[1:]
        s = np.minimum(offset + np.asarray(tile), self.volume_shape) - offset
        for j, (name, ch) in enumerate(self.mapped):
            target = self.targets[name]
            if self.mode == "masks":
                target.save_raw(res[ch, :s[0], :s[1], :s[2]] * np.uint8(255), offset,
                                self.target_mags, downsample="stride")
                continue
            data = np.ascontiguousarray(res[:s[0], :s[1], :s[2], ch])
            if pooled is None:
                target.save_raw(data, offset, self.target_mags)
                continue
            if self.mags_but_2:
                target.save_raw(data, offset, self.mags_but_2)
            h2 = -(-s // 2)
            target.save_raw(pooled[j, :h2[0], :h2[1], :h2[2]], offset // 2, (2,), data_mag=2)
        if self.seg_kd is not None:
            labels = np.argmax(res[:s[0], :s[1], :s[2]], axis=-1).astype(np.uint64)
            self.seg_kd.save_seg(labels, offset, self.target_mags)


def _stats(pred: DenseTilePredictor, route: str, n_vox: int, seconds: float, tiles: int,
           dispatches: int, **extra) -> dict:
    stats = {"n_voxels": n_vox, "seconds": seconds, "mvox_per_s": n_vox / seconds / 1e6,
             "tiles": tiles, "dispatches": dispatches, "route": route, **extra,
             "tile_shape": [int(t) for t in pred.tile_shape],
             "halo": [int(x) for x in pred.halo]}
    log.info("dense prediction (%s) done: %.1f MVx in %.1f s (%.1f MVx/s)", route, n_vox / 1e6,
             seconds, stats["mvox_per_s"])
    return stats


def _predict_stream(pred, writer: _TileWriter, src, mag, io_threads, pipeline_depth,
                    show_progress, n_dispatch):
    """The streaming route of :func:`predict_dense_to_kd`: loader threads
    prefetch source tiles, the batches go through the dispatch/fetch
    pipeline, and writer threads unpack each batch and write its tiles. The
    maps come down pooled to mag 2 where ``writer.pools_on_device``."""
    sh = writer.volume_shape
    ts, h = pred.tile_shape, pred.halo
    grid = _cdiv(sh, ts)
    tiles = [np.array([gx, gy, gz]) * ts for gx in range(grid[0])
             for gy in range(grid[1]) for gz in range(grid[2])]
    card_pool = writer.pools_on_device(ts)
    classes = [ch for _, ch in writer.mapped]

    def extent(i):
        return np.minimum(tiles[i] + ts, sh) - tiles[i]

    def load_tile(offset):
        return src.load_raw(offset=offset - h, size=ts + 2 * h, mag=mag)

    def unpack_batch_and_write(batch_ixs, got):
        raw, pooled = got if card_pool else (got, None)
        res = pred.unpack(raw)
        for k, ti in enumerate(batch_ixs):
            writer.write(tiles[ti], res[k], None if pooled is None else pooled[k])

    batch = max(1, int(pred.batch_size))
    write_pool = ThreadPoolExecutor(max_workers=io_threads)
    loader = ThreadPoolExecutor(max_workers=io_threads)
    t0 = time.perf_counter()
    n_vox = 0
    # host prefetch -> device dispatch -> host unpack + write
    batches = [list(range(i, min(i + batch, len(tiles)))) for i in range(0, len(tiles), batch)]
    prefetch_depth = pipeline_depth + 2
    load_tile, unpack_batch_and_write = (tracing.carry(load_tile),
                                         tracing.carry(unpack_batch_and_write))
    load_futs = {bi: [loader.submit(load_tile, tiles[i]) for i in batches[bi]]
                 for bi in range(min(prefetch_depth, len(batches)))}
    inflight: deque = deque()
    write_futs = []

    def drain_one():
        nonlocal n_vox
        bi, pending = inflight.popleft()
        got = pred.fetch_raw(pending)
        write_futs.append(write_pool.submit(unpack_batch_and_write, batches[bi], got))
        for i in batches[bi]:
            n_vox += int(np.prod(extent(i)))

    assembling = writer.assembling()
    try:
        for bi in range(len(batches)):
            data = np.stack([f.result() for f in load_futs.pop(bi)])
            if len(data) < batch:
                pad = np.zeros((batch - len(data),) + data.shape[1:], data.dtype)
                data = np.concatenate([data, pad])
            nxt = bi + prefetch_depth
            if nxt < len(batches):
                load_futs[nxt] = [loader.submit(load_tile, tiles[i]) for i in batches[nxt]]
            if card_pool:
                ext = np.zeros((batch, 3), np.int64)  # padding rows: 0
                ext[:len(batches[bi])] = [extent(i) for i in batches[bi]]
                inflight.append((bi, pred.dispatch(data, ext, classes)))
            else:
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
        write_pool.shutdown()
        loader.shutdown()
        assembling.close()  # every chunk on disk before the clock stops
    return _stats(pred, "stream", n_vox, time.perf_counter() - t0, len(tiles), n_dispatch)


def _packed_tile_bytes(pred: DenseTilePredictor) -> int:
    """Device bytes of one tile's packed output as the JAX package counts
    them: the minor dimension (C * patch voxels) rounded up to XLA's 128
    lanes. The port's tensors have no lane padding; the rule is kept so that
    both packages cut the same z-slabs."""
    dims = [int(pred.tile_shape[i]) // int(pred.patch[i]) for i in range(3)]
    lane = -(-int(pred.n_classes * np.prod(pred.patch)) // 128) * 128
    return int(np.prod(dims)) * lane


def _predict_resident(pred, new_predictor, writer: _TileWriter, src, res_src, mag, io_threads,
                      n_dispatch):
    """The resident route of :func:`predict_dense_to_kd`.

    The volume (resident, else loaded whole) is predicted in z-slabs when
    the packed output of all its tiles would exceed 2 GiB; slab seams then
    see a zero halo, as at the volume border. A device OOM shrinks the tile
    and makes the predictor again (``new_predictor``). With one slab and a
    resident source at mag 1, each class map is reassembled on the device
    and registered in ``io.resident`` under its target path; an OOM there
    skips the registration (logged), and consumers read the chunk store
    instead. The tiles are unpacked and written in writer threads, the maps
    at mag 2 pooled by the chunk store.
    """
    sh = writer.volume_shape
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
            del pred
            torch.cuda.empty_cache()
            pred = new_predictor(*shrunk)
    ts = pred.tile_shape
    registered = []
    if mag == 1 and res_src is not None and len(packed_parts) == 1:
        _, packed, grid_r = packed_parts[0]
        for name, ch in writer.mapped:
            try:
                cls_vol = pred.class_volume_device(packed, grid_r, int(ch),
                                                   tuple(int(x) for x in sh))
            except RuntimeError as e:
                if not _is_oom(e):
                    raise
                log.warning("skipping resident registration of %s output (device "
                            "reassembly OOM: %.80s)", name, str(e))
                break
            if resident.put(writer.targets[name].path, "raw", cls_vol, mag=mag):
                registered.append(name)
            del cls_vol

    def write_one(offset, packed_tile):
        writer.write(offset, pred.unpack(packed_tile[None])[0])

    n_tiles = 0
    write_one = tracing.carry(write_one)
    with writer.assembling(), ThreadPoolExecutor(max_workers=io_threads) as write_pool:
        futs = []
        for z_base, packed, grid_r in packed_parts:
            packed = packed if isinstance(packed, np.ndarray) else packed.cpu().numpy()
            k = 0
            for gx in range(grid_r[0]):
                for gy in range(grid_r[1]):
                    for gz in range(grid_r[2]):
                        off = np.array([gx, gy, gz]) * ts
                        off[2] += z_base
                        futs.append(write_pool.submit(write_one, off, packed[k]))
                        k += 1
            n_tiles += k
        for f in futs:
            f.result()
    return _stats(pred, "resident", int(np.prod(sh)), time.perf_counter() - t0, n_tiles,
                  n_dispatch + n_forward + pred.n_forward, tile_batch=pred.tile_batch,
                  slabs=len(packed_parts), registered=registered)
