"""Pipeline steps sharded over a device mesh (counterpart of
``syconn_tpu/parallel/sharded.py``).

* :func:`detect_cs_slab_sharded` — contact-site detection of a slab of
  ``sp`` consecutive x-chunks, the slab split along x over the mesh's
  ``sp`` axis, the stencil halo copied between devices instead of re-read
  from disk;
* :func:`segment_slab_sharded` — the object-extraction chain (blur,
  threshold, morphology) on an x-split slab;
* :func:`object_properties_sharded` / :func:`pair_counts_sharded` — the
  property scan and the organelle -> cell overlap counts of an x-split
  volume, per-shard tables merged on the host;
* data-parallel dense and point inference live in ``inference/dense.py``
  and ``inference/points.py`` (their ``mesh=``).

Every function equals its serial counterpart bit for bit: each shard sees
exactly the (chunk + halo) window that the serial path loads from disk,
because the slab is loaded once with its outer halo and the interior halos
travel between devices. One process drives every shard (see
``parallel/device.py``); each shard's ops and kernels run on its own
device's current stream.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import DeviceMesh, data_sharding, on_device, place

__all__ = ["mesh_from_config", "slab_runs", "sharded_slab_apply", "detect_cs_slab_sharded",
           "segment_slab_sharded", "object_properties_sharded", "pair_counts_sharded"]


def mesh_from_config(axis_name: str = "sp", device=None) -> Optional[DeviceMesh]:
    """A 1-d mesh over every CUDA device whenever more than one is attached
    and ``tpu.shard_pipeline`` is not false (default on, as in the JAX
    package); else None, and the steps run serially. ``device``: the
    calling entry point's device; a CPU run is never sharded over the
    cards."""
    from .. import global_params

    try:
        enabled = global_params.config["tpu"].get("shard_pipeline", True)
    except KeyError:
        enabled = True
    if enabled is False:
        return None
    if device is not None and torch.device(device).type != "cuda":
        return None
    n = torch.cuda.device_count()
    if n < 2:
        return None
    from .device import get_device_mesh

    return get_device_mesh(n, axis_names=(axis_name,))


def slab_runs(grid: Sequence[int], n_sp: int, pad: bool = False
              ) -> Tuple[List[Tuple[int, int, int]], List[Tuple[int, int, int]]]:
    """Partition a chunk grid into x-runs of ``n_sp`` consecutive full
    chunks (sharded slabs).

    Returns (slab_starts, serial_chunks); a slab start (cx, cy, cz) covers
    chunks cx..cx+n_sp-1 in the same (cy, cz) column.

    With ``pad=False`` the remainder x-chunks go to the serial list. With
    ``pad=True`` a final slab per column covers them too — it may extend
    past the grid (chunked loads zero-pad out-of-bounds reads, and callers
    skip outputs of chunks with cx >= grid[0]) so EVERY chunk runs on the
    sharded path and the serial list is empty.
    """
    slabs = []
    serial = []
    n_full = (grid[0] // n_sp) * n_sp
    for cy in range(grid[1]):
        for cz in range(grid[2]):
            for cx in range(0, n_full, n_sp):
                slabs.append((cx, cy, cz))
            if n_full < grid[0]:
                if pad:
                    slabs.append((n_full, cy, cz))
                else:
                    serial.extend((cx, cy, cz) for cx in range(n_full, grid[0]))
    return slabs, serial


def _halo_exchange_with_boundary(shards: Sequence[torch.Tensor], halo: int, lo: torch.Tensor,
                                 hi: torch.Tensor) -> List[torch.Tensor]:
    """Each x-shard padded with its neighbours' border slabs; the mesh-edge
    shards take the explicit (disk-loaded) boundary slabs instead, so every
    padded window equals the serial per-chunk disk load."""
    n = len(shards)
    out = []
    for i, local in enumerate(shards):
        dev = local.device
        left = place(lo if i == 0 else shards[i - 1][-halo:], dev)
        right = place(hi if i == n - 1 else shards[i + 1][:halo], dev)
        out.append(torch.cat([left, local, right], dim=0))
    return out


def sharded_slab_apply(kernel: Callable, slab_padded, mesh: DeviceMesh, halo_x: int,
                       axis_name: str = "sp") -> list:
    """Run ``kernel(padded_local)`` over an x-split slab; returns the
    shards' outputs in mesh order (each on its shard's device).

    ``slab_padded`` (numpy or a tensor) carries ``halo_x`` extra slabs on
    both x ends (the disk-loaded outer halo); its core x extent must divide
    over the mesh axis. Each shard's kernel sees its core plus ``halo_x``
    slabs from each x neighbour (interior: copied from the neighbour's
    device; slab ends: the outer halo), with its device current."""
    n = mesh.shape[axis_name]
    slab = (torch.from_numpy(np.ascontiguousarray(slab_padded))
            if isinstance(slab_padded, np.ndarray) else slab_padded)
    core = slab[halo_x:slab.shape[0] - halo_x]
    if core.shape[0] % n:
        raise ValueError(f"slab core x extent {core.shape[0]} must divide over {n} shards")
    shards = data_sharding(core, mesh, axis_name, dim=0)
    if halo_x > 0:
        padded = _halo_exchange_with_boundary(shards, halo_x, slab[:halo_x], slab[-halo_x:])
    else:
        padded = shards
    outs = []
    for p in padded:
        with on_device(p.device):
            outs.append(kernel(p))
    return outs


# --------------------------------------------------------------------- cs


def detect_cs_slab_sharded(seg_slab_padded: np.ndarray, mesh: DeviceMesh,
                           stencil: Sequence[int] = (13, 13, 7),
                           tile: Sequence[int] = (32, 32, 16), K: int = 32,
                           axis_name: str = "sp", kernel: str = "auto") -> np.ndarray:
    """Contact partners of a slab of ``sp`` consecutive x-chunks.

    ``seg_slab_padded`` is the slab *including* the stencil halo in all
    three dims (what the serial worker loads per chunk, for the whole slab
    at once). Output: the packed uint64 contact segmentation of the
    valid-convolution shape ``slab - stencil + 1``, equal to
    ``ops.contacts.detect_cs`` on it. ``kernel`` (as for
    ``ops.contacts_torch.CsDispatcher``): ``"auto"`` runs the column kernel
    (``ops/csrc/contacts.cu``) on tables built on a shard's card and the
    per-tile formulation on the CPU; ``"cuda"`` the column formulation
    everywhere, ``"torch"`` the tiles. Overflowing columns (tiles) are
    recomputed by the host kernel in shard-local coordinates. Labels must
    be below 2**31 (callers route larger ids to the serial path).
    """
    if kernel not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown cs kernel: {kernel!r}")
    from ..ops.contacts_torch import (_pack, _patch_overflow, detect_cs_columns_device,
                                      detect_cs_device)

    stencil = tuple(int(s) for s in stencil)
    tile = tuple(int(t) for t in tile)
    hx = stencil[0] // 2
    if seg_slab_padded.max(initial=0) >= 2**31:
        raise ValueError("the sharded contact path takes labels < 2**31")
    seg32 = np.ascontiguousarray(seg_slab_padded.astype(np.int32))

    def detect(padded):
        if kernel == "cuda" or (kernel == "auto" and padded.device.type == "cuda"):
            return detect_cs_columns_device(padded, stencil, tile[:2], K) + (tile[:2],)
        return detect_cs_device(padded, stencil, tile, K) + (tile,)

    n = mesh.shape[axis_name]
    shard_x = (seg32.shape[0] - 2 * hx) // n
    parts = []
    for s, (partners, overflow, t) in enumerate(
            sharded_slab_apply(detect, seg32, mesh, hx, axis_name)):
        packed = _pack(partners.cpu().numpy())
        # the shard's own window: its core rows plus the stencil halo
        window = seg_slab_padded[s * shard_x:(s + 1) * shard_x + 2 * hx]
        parts.append(_patch_overflow(packed, overflow.cpu().numpy(), window, stencil, t))
    return np.concatenate(parts, axis=0)


# ------------------------------------------------------------ segmentation


def segment_slab_sharded(prob_slab_padded: np.ndarray, thresh_uint8: float,
                         morph_ops: Sequence[str], struct: np.ndarray, mesh: DeviceMesh,
                         halo: int, sigma: float = 0.0, axis_name: str = "sp"
                         ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Blur + threshold + morphology chain on an x-split slab.

    ``prob_slab_padded`` carries ``halo`` voxels on both ends of every dim.
    Returns (masks, eroded, n_trailing_ero) where ``masks``/``eroded`` are
    (n_sp, cx + 2*halo, Y + 2*halo, Z + 2*halo) bool — each shard's chunk
    *including* its halo, equal to the per-chunk device chain
    (``ops.morphology_torch.segment_chunk_device``) on the serial path's
    disk-loaded window. The haloed (not cropped) masks matter because the
    serial worker labels connected components on the haloed chunk before
    cropping. Each shard reads back its 2-bit packed ``mask | eroded << 1``.
    """
    from ..ops.morphology_torch import (_check_struct, _segment_chunk_packed, _split_ops,
                                        _unpack)

    _check_struct(struct)
    pre_ops, n_tr = _split_ops(morph_ops)
    struct_t = torch.from_numpy(np.asarray(struct, bool))
    structs = {}

    def kernel(padded):
        if padded.device not in structs:
            structs[padded.device] = place(struct_t, padded.device)
        return _segment_chunk_packed(padded, float(thresh_uint8), structs[padded.device],
                                     pre_ops, n_tr, float(sigma))

    wz = prob_slab_padded.shape[2]
    codes = np.stack([_unpack(p.cpu().numpy(), wz) for p in sharded_slab_apply(
        kernel, prob_slab_padded, mesh, halo, axis_name)])
    return (codes & 1).astype(bool), (codes >> 1).astype(bool), n_tr


# ------------------------------------------------------------------- props


def _shards_int32(vol: np.ndarray, mesh: DeviceMesh, axis_name: str) -> List[torch.Tensor]:
    if vol.shape[0] % mesh.shape[axis_name]:
        raise ValueError(f"x extent {vol.shape[0]} must divide over "
                         f"{mesh.shape[axis_name]} '{axis_name}' shards")
    if int(vol.max(initial=0)) >= 2**31:
        raise ValueError("the sharded scans take labels < 2**31")
    return data_sharding(torch.from_numpy(np.ascontiguousarray(vol.astype(np.int32))), mesh,
                         axis_name, dim=0)


def object_properties_sharded(vol: np.ndarray, mesh: DeviceMesh, max_ids: int = 4096,
                              axis_name: str = "sp"
                              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-object (id, rep_coord, bounding box, size) of an x-split label
    volume: per-shard sorted segment reductions on each shard's device, the
    shards merged on the host. Same contract as
    ``ops.props.object_properties_arrays`` (ascending unique nonzero ids;
    rep coord = first voxel in C scan order, which the merge in ascending x
    keeps). A shard with more labels than the table grows it to the next
    power of two above the largest count and every shard is scanned again."""
    from ..ops.props import merge_prop_arrays
    from ..ops.props_torch import object_properties_device

    n = mesh.shape[axis_name]
    shards = _shards_int32(vol, mesh, axis_name)
    shard_x = vol.shape[0] // n
    while True:  # grow the padded table until every shard's labels fit
        cap = max_ids
        outs = []
        for local in shards:
            with on_device(local.device):
                outs.append(object_properties_device(local, cap))
        n_seg = np.array([int(o[4]) for o in outs])
        worst = int(n_seg.max(initial=0))
        if worst <= max_ids:
            break
        # grow directly to the observed need
        max_ids = 1 << int(np.ceil(np.log2(worst)))
    max_ids = cap
    per_shard = []
    for s, (ids, rep, bb, sizes, _) in enumerate(outs):
        ids, rep, bb, sizes = (t.cpu().numpy() for t in (ids, rep, bb, sizes))
        valid = ids != 0
        order = np.argsort(ids[valid], kind="stable")
        off = np.array([s * shard_x, 0, 0], np.int64)
        per_shard.append((ids[valid][order].astype(vol.dtype),
                          rep[valid][order].astype(np.int64) + off,
                          bb[valid][order].astype(np.int64) + off[None, :],
                          sizes[valid][order].astype(np.int64)))
    return merge_prop_arrays(per_shard)


def pair_counts_sharded(a: np.ndarray, b: np.ndarray, mesh: DeviceMesh,
                        max_pairs: int = 4096, axis_name: str = "sp"
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Nonzero (a, b) co-occurrence counts of x-split volumes (the
    organelle -> cell mapping scan), per-shard tables merged on the host.
    Same contract as ``ops.props.pair_counts``."""
    from ..ops.props_torch import pair_counts_device

    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} and {b.shape}")
    sa, sb = _shards_int32(a, mesh, axis_name), _shards_int32(b, mesh, axis_name)
    while True:  # grow the padded pair table until every shard fits
        cap = max_pairs
        outs = []
        for la, lb in zip(sa, sb):
            with on_device(la.device):
                outs.append(pair_counts_device(la, lb, cap))
        worst = max(int(o[3]) for o in outs)
        if worst <= max_pairs:
            break
        max_pairs = 1 << int(np.ceil(np.log2(worst)))
    max_pairs = cap
    a_out = np.concatenate([o[0].cpu().numpy() for o in outs])
    b_out = np.concatenate([o[1].cpu().numpy() for o in outs])
    cnt = np.concatenate([o[2].cpu().numpy() for o in outs])
    # cross-shard merge: (a, b) packed into one int64 key, one unique and
    # one bincount
    ok = (a_out != 0) & (b_out != 0)
    if not ok.any():
        return np.zeros(0, a.dtype), np.zeros(0, b.dtype), np.zeros(0, np.int64)
    keys = (a_out[ok].astype(np.int64) << 32) | b_out[ok].astype(np.int64)
    uk, inv = np.unique(keys, return_inverse=True)
    counts = np.bincount(inv, weights=cnt[ok].astype(np.float64)).astype(np.int64)
    return (uk >> 32).astype(a.dtype), (uk & 0xFFFFFFFF).astype(b.dtype), counts
