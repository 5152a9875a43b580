"""Plain tiled dense prediction: what every route's output is held against.

The volume is covered by a grid of ``tile``-sized tiles from the origin;
each tile is predicted from its window of ``tile + 2 * halo`` voxels
(zeros outside the volume), the halo cropped, and the tile's probabilities
kept where it lies inside the volume. The mag-2 level of a map is the
2 x 2 x 2 mean, rounded down, of the mag-1 map cut at each tile and
edge-padded to even extents.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def grid_of(shape: Sequence[int], tile: Sequence[int]) -> Tuple[int, int, int]:
    return tuple(-(-int(s) // int(t)) for s, t in zip(shape, tile))


def tile_offsets(shape, tile):
    g = grid_of(shape, tile)
    return [(gx * int(tile[0]), gy * int(tile[1]), gz * int(tile[2]))
            for gx in range(g[0]) for gy in range(g[1]) for gz in range(g[2])]


def window(vol: torch.Tensor, offset, tile, halo) -> torch.Tensor:
    """The tile's input window, zeros where it leaves the volume."""
    lo = [int(o) - int(h) for o, h in zip(offset, halo)]
    size = [int(t) + 2 * int(h) for t, h in zip(tile, halo)]
    out = torch.zeros(size, dtype=torch.uint8, device=vol.device)
    src_lo = [max(a, 0) for a in lo]
    src_hi = [min(a + s, int(n)) for a, s, n in zip(lo, size, vol.shape)]
    if all(h > l for l, h in zip(src_lo, src_hi)):
        out[src_lo[0] - lo[0]:src_hi[0] - lo[0], src_lo[1] - lo[1]:src_hi[1] - lo[1],
            src_lo[2] - lo[2]:src_hi[2] - lo[2]] = vol[src_lo[0]:src_hi[0],
                                                       src_lo[1]:src_hi[1],
                                                       src_lo[2]:src_hi[2]]
    return out


@torch.no_grad()
def predict_tile(forward: Callable, vol: torch.Tensor, offset, tile, halo,
                 precision: str = "f32") -> Tuple[Tuple[int, ...], torch.Tensor]:
    """One tile -> (its extent inside the volume, uint8 probabilities
    (C, ex, ey, ez)). ``forward(window, precision)`` is the model family's
    plain forward: the window (X, Y, Z) uint8 -> uint8 (C, X, Y, Z), in
    float32 with TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    probs = forward(window(vol, offset, tile, halo), precision)
    lo = [int(h) for h in halo]
    ext = tuple(min(int(t), int(n) - int(o)) for t, n, o in zip(tile, vol.shape, offset))
    return ext, probs[:, lo[0]:lo[0] + ext[0], lo[1]:lo[1] + ext[1], lo[2]:lo[2] + ext[2]]


def mag2_tile(u8: torch.Tensor) -> torch.Tensor:
    """(X, Y, Z) uint8 -> the 2 x 2 x 2 mean rounded down, the block
    edge-padded to even extents first."""
    pad = [(-int(s)) % 2 for s in u8.shape]
    v = u8.to(torch.int32)
    if any(pad):
        v = torch.nn.functional.pad(v[None, None].float(), (0, pad[2], 0, pad[1], 0, pad[0]),
                                    mode="replicate")[0, 0].to(torch.int32)
    X, Y, Z = v.shape
    s = v.reshape(X // 2, 2, Y // 2, 2, Z // 2, 2).sum(dim=(1, 3, 5))
    return (s // 8).to(torch.uint8)
