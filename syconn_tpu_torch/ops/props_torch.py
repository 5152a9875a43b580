"""Per-object property scans as PyTorch ops on a device (counterpart of
``syconn_tpu/ops/props_jax.py``).

The chunk is flattened, stably sorted by label, and per-label statistics
come from segment reductions over the sorted order (``scatter_reduce`` with
the initial values kept, ``index_add_``). Outputs are ``max_ids``-padded
tables; row ``i`` is valid iff ``ids[i] != 0``. Segment indices are clamped
to the last row, so a chunk with more labels than rows folds the surplus
into it; the host wrappers detect this from the segment count and raise
(:func:`object_properties_torch`, :func:`pair_counts_torch`) or grow the
table (:class:`ResidentPropsScanner`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import default_device

__all__ = [
    "object_properties_device",
    "object_properties_torch",
    "pair_counts_device",
    "pair_counts_torch",
    "ResidentPropsScanner",
]

_I32_MAX = int(np.iinfo(np.int32).max)


@torch.no_grad()
def object_properties_device(chunk: torch.Tensor, max_ids: int):
    """Per-label stats of an int32 label volume on its device.

    Returns (ids (max_ids,), rep (max_ids, 3), bb (max_ids, 2, 3),
    sizes (max_ids,), n_segments) as int32 tensors, padded with id 0 rows;
    ``n_segments`` counts the distinct labels, background included.
    """
    sx, sy, sz = chunk.shape
    flat = chunk.reshape(-1).to(torch.int32)
    sids, order = torch.sort(flat, stable=True)
    oz = order % sz
    oy = (order // sz) % sy
    ox = order // (sy * sz)
    coords = torch.stack([ox, oy, oz], dim=1).to(torch.int32)
    first = torch.ones_like(sids, dtype=torch.bool)
    first[1:] = sids[1:] != sids[:-1]
    seg_ix = (torch.cumsum(first, 0) - 1).clamp_max(max_ids - 1)
    dev = chunk.device
    ids = torch.zeros(max_ids, dtype=torch.int32, device=dev).scatter_reduce(
        0, seg_ix, sids, "amax", include_self=True)
    sizes = torch.zeros(max_ids, dtype=torch.int32, device=dev).index_add_(
        0, seg_ix, torch.ones_like(sids))
    seg3 = seg_ix[:, None].expand(-1, 3)
    mins = torch.full((max_ids, 3), _I32_MAX, dtype=torch.int32, device=dev).scatter_reduce(
        0, seg3, coords, "amin", include_self=True)
    maxs = torch.full((max_ids, 3), -1, dtype=torch.int32, device=dev).scatter_reduce(
        0, seg3, coords, "amax", include_self=True)
    # representative coordinate: the first voxel in C scan order, i.e. the
    # smallest flat index of the segment
    best_flat = torch.full((max_ids,), _I32_MAX, dtype=torch.int32, device=dev).scatter_reduce(
        0, seg_ix, order.to(torch.int32), "amin", include_self=True)
    rep = torch.stack([best_flat // (sy * sz), (best_flat // sz) % sy, best_flat % sz], dim=1)
    valid = ids != 0
    sizes = torch.where(valid, sizes, torch.zeros_like(sizes))
    bb = torch.stack([mins, maxs + 1], dim=1)
    bb = torch.where(valid[:, None, None], bb, torch.zeros_like(bb))
    rep = torch.where(valid[:, None], rep, torch.zeros_like(rep))
    return ids, rep, bb, sizes, first.sum()


def _compact(ids, rep, bb, sizes, id_dtype):
    ids = ids.cpu().numpy()
    valid = ids != 0
    order = np.argsort(ids[valid], kind="stable")
    return (ids[valid][order].astype(id_dtype),
            rep.cpu().numpy()[valid][order].astype(np.int64),
            bb.cpu().numpy()[valid][order].astype(np.int64),
            sizes.cpu().numpy()[valid][order].astype(np.int64))


def object_properties_torch(chunk: np.ndarray, max_ids: int = 4096, device=None
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host wrapper with the contract of ``ops.props.object_properties_arrays``
    (compact arrays, ascending nonzero ids; mirrors
    ``props_jax.object_properties_tpu``). Labels must fit int32; raises when
    the chunk holds more labels than ``max_ids``. ``device``: None means the
    CUDA card (required); ``"cpu"`` runs the same ops on the CPU."""
    device = default_device(device)
    chunk = np.ascontiguousarray(chunk)
    if int(chunk.max(initial=0)) >= 2**31:
        raise ValueError("int32 label space required on the device")
    ids, rep, bb, sizes, n_seg = object_properties_device(
        torch.from_numpy(chunk.astype(np.int32)).to(device), max_ids)
    if int(n_seg) > max_ids:
        raise ValueError(f"chunk has {int(n_seg)} unique labels > max_ids={max_ids}; "
                         "raise max_ids")
    return _compact(ids, rep, bb, sizes, chunk.dtype)


@torch.no_grad()
def pair_counts_device(a: torch.Tensor, b: torch.Tensor, max_pairs: int):
    """Co-occurrence counts of nonzero (a, b) int32 label pairs on the
    device (device analog of ``ops.props.pair_counts``).

    Returns (a_ids, b_ids, counts, n_pairs), the first three padded to
    ``max_pairs``; ``n_pairs`` counts the distinct pairs.
    """
    af = a.reshape(-1).to(torch.int32)
    bf = b.reshape(-1).to(torch.int32)
    valid = (af != 0) & (bf != 0)
    big = torch.full_like(af, _I32_MAX)
    # a * 2**31 would overflow int32: two stable sorts, by b then by a
    order1 = torch.sort(torch.where(valid, bf, big), stable=True).indices
    a1, b1, v1 = af[order1], bf[order1], valid[order1]
    order2 = torch.sort(torch.where(v1, a1, big), stable=True).indices
    a2, b2, v2 = a1[order2], b1[order2], v1[order2]
    new = torch.ones_like(v2)
    new[1:] = (a2[1:] != a2[:-1]) | (b2[1:] != b2[:-1])
    new &= v2
    seg = torch.cumsum(new, 0) - 1
    n_pairs = new.sum()
    seg = torch.where(v2, seg.clamp_max(max_pairs - 1), torch.full_like(seg, max_pairs - 1))
    zero = torch.zeros_like(a2)
    dev = a.device

    def table(vals, how):
        out = torch.zeros(max_pairs, dtype=torch.int32, device=dev)
        if how == "add":
            return out.index_add_(0, seg, vals)
        return out.scatter_reduce(0, seg, vals, "amax", include_self=True)

    a_out = table(torch.where(v2, a2, zero), "max")
    b_out = table(torch.where(v2, b2, zero), "max")
    cnt = table(v2.to(torch.int32), "add")
    ok = (a_out != 0) & (b_out != 0)
    z = torch.zeros_like(a_out)
    return torch.where(ok, a_out, z), torch.where(ok, b_out, z), torch.where(ok, cnt, z), n_pairs


def pair_counts_torch(a: np.ndarray, b: np.ndarray, max_pairs: int = 4096, device=None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host wrapper with the contract of ``ops.props.pair_counts`` (compact
    arrays of nonzero (a, b) pairs and counts; mirrors
    ``props_jax.pair_counts_tpu``). Raises when the chunk holds more pairs
    than ``max_pairs``. ``device`` as :func:`object_properties_torch`."""
    device = default_device(device)
    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b)
    if max(int(a.max(initial=0)), int(b.max(initial=0))) >= 2**31:
        raise ValueError("int32 label space required on the device")
    a_out, b_out, cnt, n_pairs = pair_counts_device(
        torch.from_numpy(a.astype(np.int32)).to(device),
        torch.from_numpy(b.astype(np.int32)).to(device), max_pairs)
    if int(n_pairs) > max_pairs:
        raise ValueError(f"chunk has {int(n_pairs)} unique (a, b) pairs > max_pairs="
                         f"{max_pairs}; raise max_pairs")
    a_out, b_out, cnt = a_out.cpu().numpy(), b_out.cpu().numpy(), cnt.cpu().numpy()
    ok = (a_out != 0) & (b_out != 0)
    return a_out[ok], b_out[ok], cnt[ok].astype(np.int64)


class ResidentPropsScanner:
    """Per-chunk property scans over a label volume held in device memory:
    the chunk is sliced on the device and only the padded tables come back.
    Same contract as ``ops.props.object_properties_arrays`` (chunk-local
    coordinates), ids as uint64."""

    def __init__(self, vol_dev: torch.Tensor, chunk: Sequence[int] = (256, 256, 128)):
        self.chunk = tuple(int(c) for c in chunk)
        self.sh = tuple(int(s) for s in vol_dev.shape)
        hi = [-(-self.sh[i] // self.chunk[i]) * self.chunk[i] - self.sh[i] for i in range(3)]
        self._padded = F.pad(vol_dev.to(torch.int32), (0, hi[2], 0, hi[1], 0, hi[0]))

    def props(self, cix, max_ids: int = 4096):
        """(ids, rep, bb, sizes) of chunk (cx, cy, cz). Boundary chunks run
        on their zero-padded full window: the padding only feeds the dropped
        background segment. On overflow the table grows to the next power of
        two above the segment count and the scan reruns."""
        o = [int(cix[i]) * self.chunk[i] for i in range(3)]
        w = self._padded[o[0]:o[0] + self.chunk[0], o[1]:o[1] + self.chunk[1],
                         o[2]:o[2] + self.chunk[2]]
        while True:
            ids, rep, bb, sizes, n_seg = object_properties_device(w, max_ids)
            n_seg = int(n_seg)
            if n_seg <= max_ids:
                break
            max_ids = 1 << int(np.ceil(np.log2(n_seg)))
        return _compact(ids, rep, bb, sizes, np.uint64)
