"""Binary morphology and the object-segmentation chunk chain as PyTorch ops
on a device (counterpart of ``syconn_tpu/ops/morphology_jax.py``).

Erosion and dilation are structuring-element hit counts, one 3D convolution
of the {0, 1} mask with the structuring element ('same' padding, i.e. zero
borders, scipy's default):

* dilation: ``count > 0.5``
* erosion:  ``count >= n_hits - 0.5``
* opening/closing: the two composed.

The counts are sums of at most a few dozen ones in float32 and the tests sit
half a unit away from every integer, so any convolution algorithm gives the
same masks (TF32 is off: ``utils.device.default_device``).

:func:`segment_chunk_device` runs blur, threshold and the configured chain
on one chunk window and reads back ``mask | eroded << 1`` packed four voxels
a byte along z; :class:`ResidentSegmenter` does the same for windows sliced
from a probability map held in device memory (``io.resident``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..io.resident import fetch
from ..utils.device import default_device

__all__ = ["morphology_chain_device", "segment_chunk_device", "ResidentSegmenter"]


def _conv_count(mask: torch.Tensor, struct: torch.Tensor) -> torch.Tensor:
    """Count of structuring-element hits per voxel ('same' padding)."""
    pad = tuple(int(s) // 2 for s in struct.shape)
    out = F.conv3d(mask.to(torch.float32)[None, None], struct.to(torch.float32)[None, None],
                   padding=pad)
    return out[0, 0]


def _erode(mask, struct, n_hits):
    return _conv_count(mask, struct) >= n_hits - 0.5


def _dilate(mask, struct, n_hits):
    return _conv_count(mask, struct) > 0.5


def _check_struct(struct: np.ndarray) -> None:
    if any(int(s) % 2 == 0 for s in np.shape(struct)):
        # SAME padding of an even extent is asymmetric; get_aniso_struct is odd
        raise ValueError(f"structuring element must have odd extents, got {np.shape(struct)}")


def _chain(mask: torch.Tensor, struct: torch.Tensor, ops: Sequence[str]) -> torch.Tensor:
    n_hits = float(struct.sum())
    for op in ops:
        if op == "binary_erosion":
            mask = _erode(mask, struct, n_hits)
        elif op == "binary_dilation":
            mask = _dilate(mask, struct, n_hits)
        elif op == "binary_opening":
            mask = _dilate(_erode(mask, struct, n_hits), struct, n_hits)
        elif op == "binary_closing":
            mask = _erode(_dilate(mask, struct, n_hits), struct, n_hits)
        else:
            raise ValueError(op)
    return mask


@torch.no_grad()
def morphology_chain_device(mask: np.ndarray, operations: Sequence[str], struct: np.ndarray,
                            device=None) -> np.ndarray:
    """Apply a named chain of binary ops on ``device``; matches
    ``ops.morphology.apply_morphological_operations`` (zero borders).
    ``device``: None means the CUDA card (required); ``"cpu"`` runs the same
    ops on the CPU."""
    device = default_device(device)
    _check_struct(struct)
    out = _chain(torch.from_numpy(np.ascontiguousarray(mask, bool)).to(device),
                 torch.from_numpy(np.asarray(struct, bool)).to(device), tuple(operations))
    return out.cpu().numpy()


def _blur(data: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur, radius ceil(3 sigma), zero borders."""
    r = int(np.ceil(3 * sigma))
    xs = torch.arange(-r, r + 1, dtype=torch.float32, device=data.device)
    g = torch.exp(-0.5 * (xs / sigma) ** 2)
    g = g / torch.sum(g)
    data = data[None, None]
    for ax in range(3):
        shape = [1, 1, 1]
        shape[ax] = 2 * r + 1
        pad = [0, 0, 0]
        pad[ax] = r
        data = F.conv3d(data, g.reshape([1, 1] + shape), padding=tuple(pad))
    return data[0, 0]


def _segment_chunk(prob: torch.Tensor, thresh, struct: torch.Tensor, pre_ops, n_trailing_ero,
                   sigma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    data = prob.to(torch.float32)
    if sigma > 0:
        data = _blur(data, sigma)
    mask = _chain(data >= thresh, struct, pre_ops)
    eroded = mask
    if n_trailing_ero > 0:
        n_hits = float(struct.sum())
        for _ in range(n_trailing_ero):
            eroded = _erode(eroded, struct, n_hits)
    return mask, eroded


def _segment_chunk_packed(prob, thresh, struct, pre_ops, n_trailing_ero,
                          sigma: float) -> torch.Tensor:
    """``mask | eroded << 1`` packed four voxels a byte along z (weights 1,
    4, 16, 64; z zero-padded to a multiple of 4): 8x fewer bytes to read
    back than two bool arrays."""
    mask, eroded = _segment_chunk(prob, thresh, struct, pre_ops, n_trailing_ero, sigma)
    two = mask.to(torch.uint8) | (eroded.to(torch.uint8) << 1)
    sx, sy, sz = two.shape
    pad = (-sz) % 4
    if pad:
        two = F.pad(two, (0, pad))
    two = two.reshape(sx, sy, (sz + pad) // 4, 4)
    w = torch.tensor([1, 4, 16, 64], dtype=torch.uint8, device=two.device)
    return torch.sum(two * w, dim=-1, dtype=torch.uint8)


def _unpack(packed: np.ndarray, wz: int) -> np.ndarray:
    """Host unpack: byte -> four 2-bit codes along z, cropped to ``wz``."""
    codes = np.stack([packed & 3, (packed >> 2) & 3, (packed >> 4) & 3, (packed >> 6) & 3],
                     axis=-1)
    return codes.reshape(packed.shape[0], packed.shape[1], -1)[:, :, :wz]


def _split_ops(morph_ops: Sequence[str]) -> Tuple[Tuple[str, ...], int]:
    """(ops before the trailing erosions, number of trailing erosions)."""
    morph_ops = list(morph_ops or [])
    n_tr = 0
    for op in reversed(morph_ops):
        if op == "binary_erosion":
            n_tr += 1
        else:
            break
    return tuple(morph_ops[:len(morph_ops) - n_tr]), n_tr


class ResidentSegmenter:
    """Object-segmentation chunk chains over a probability map held in
    device memory: each chunk + halo window is sliced on the device and only
    the 2-bit packed ``mask | eroded << 1`` is read back. The result equals
    the streaming path's per-chunk windows (past the volume boundary the
    window is zero either way)."""

    def __init__(self, prob_dev: torch.Tensor, chunk, halo: int, thresh_uint8: float,
                 morph_ops, struct, sigma: float = 0.0):
        _check_struct(struct)
        self.chunk = tuple(int(c) for c in chunk)
        self.halo = int(halo)
        self.sh = tuple(int(s) for s in prob_dev.shape)
        self.pre_ops, self.n_tr = _split_ops(morph_ops)
        grid = tuple(-(-self.sh[i] // self.chunk[i]) for i in range(3))
        h = self.halo
        hi = [grid[i] * self.chunk[i] - self.sh[i] + h for i in range(3)]
        self._padded = F.pad(prob_dev.to(torch.uint8), (h, hi[2], h, hi[1], h, hi[0]))
        self._struct = torch.from_numpy(np.asarray(struct, bool)).to(prob_dev.device)
        self._win = tuple(self.chunk[i] + 2 * h for i in range(3))
        self._thresh = float(thresh_uint8)
        self._sigma = float(sigma)

    @torch.no_grad()
    def dispatch(self, cix):
        o = [int(cix[i]) * self.chunk[i] for i in range(3)]
        w = self._padded[o[0]:o[0] + self._win[0], o[1]:o[1] + self._win[1],
                         o[2]:o[2] + self._win[2]]
        return cix, _segment_chunk_packed(w, self._thresh, self._struct, self.pre_ops,
                                          self.n_tr, self._sigma)

    def fetch(self, handle):
        """-> (mask, eroded, n_trailing_ero) for the chunk's haloed window
        (cropped to size + 2 * halo at the volume boundary)."""
        cix, dev = handle
        h = self.halo
        codes = _unpack(fetch(dev), self._win[2])
        size = [min(self.chunk[i], self.sh[i] - int(cix[i]) * self.chunk[i]) for i in range(3)]
        codes = codes[:size[0] + 2 * h, :size[1] + 2 * h, :size[2] + 2 * h]
        return (codes & 1).astype(bool), (codes >> 1).astype(bool), self.n_tr


@torch.no_grad()
def segment_chunk_device(prob: np.ndarray, thresh_uint8: float, morph_ops: Sequence[str],
                         struct: np.ndarray, sigma: float = 0.0,
                         device=None) -> Tuple[np.ndarray, np.ndarray, int]:
    """Device half of the object-segmentation chunk worker: blur, threshold
    and morphology chain; returns (mask, eroded seed mask, n_trailing_ero)
    through the 2-bit packed readback. ``device``: None means the CUDA card
    (required); ``"cpu"`` runs the same ops on the CPU."""
    device = default_device(device)
    _check_struct(struct)
    pre_ops, n_tr = _split_ops(morph_ops)
    packed = _segment_chunk_packed(
        torch.from_numpy(np.ascontiguousarray(prob)).to(device), float(thresh_uint8),
        torch.from_numpy(np.asarray(struct, bool)).to(device), pre_ops, n_tr, float(sigma))
    codes = _unpack(packed.cpu().numpy(), prob.shape[2])
    return (codes & 1).astype(bool), (codes >> 1).astype(bool), n_tr
