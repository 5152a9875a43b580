"""How ``correct`` is decided: the routes' outputs against the plain
reference, tile by tile, in uint8 probability steps (LSB).

Numbers compared (each against the limit in ``perfbench/limits/<cell>.json``):

* ``mean_abs_lsb``: the mean |program - reference| over every compared
  voxel of every mapped class at mag 1;
* ``max_abs_lsb``: the widest such gap;
* ``mag2_*``: the same at mag 2, where the route writes a pyramid.

A compared tile whose output is missing counts as failed, and a run with a
missing output is not correct. With ``control=True`` the reference in
float8 takes the program's place: the readings a limit must stay below.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..reference import dense as ref_dense
from .inputs import stream_seed


class Tally:
    def __init__(self):
        self.sum = 0
        self.count = 0
        self.max = 0
        self.tile_max: List[int] = []

    def add_tile(self, diffs: Sequence[torch.Tensor]) -> None:
        m = 0
        for d in diffs:
            self.sum += int(d.sum(dtype=torch.int64))
            self.count += d.numel()
            m = max(m, int(d.max()) if d.numel() else 0)
        self.max = max(self.max, m)
        self.tile_max.append(m)

    def numbers(self, prefix: str = "") -> Dict[str, float]:
        if not self.count:
            return {}
        return {f"{prefix}mean_abs_lsb": self.sum / self.count, f"{prefix}max_abs_lsb": float(self.max)}


def absdiff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(torch.int16) - b.to(device=a.device, dtype=torch.int16)).abs()


def sample_offsets(shape, tile, k: int, seed: int) -> List[tuple]:
    """``k`` tile offsets drawn from the seed; the last tile (the corner
    that the volume cuts) is always among them. ``k <= 0``: every tile."""
    offs = ref_dense.tile_offsets(shape, tile)
    if k <= 0 or k >= len(offs):
        return offs
    rng = np.random.default_rng(stream_seed(seed, 3))
    pick = set(rng.choice(len(offs) - 1, size=k - 1, replace=False).tolist())
    return [offs[i] for i in sorted(pick)] + [offs[-1]]


def compare_tiles(reference: Callable, vol: torch.Tensor, tile, halo,
                  mapping: Dict[str, int], offsets, program_tile: Callable,
                  control: bool = False, keep: Optional[Callable] = None) -> Tally:
    """Tally |program - reference| over the tiles at ``offsets``.
    ``reference(window, precision)`` is the family's plain forward (uint8
    (C, X, Y, Z) of a window); ``program_tile(offset, extent)`` gives {map
    name: uint8 (ex, ey, ez)} or None when missing; ``keep(offset, extent,
    name, ref_u8, prog_u8)`` sees every compared pair (for the mag-2 level)."""
    t = Tally()
    for off in offsets:
        ext, ref = ref_dense.predict_tile(reference, vol, off, tile, halo, "f32")
        if control:
            _, low = ref_dense.predict_tile(reference, vol, off, tile, halo, "fp8")
            prog = {n: low[c] for n, c in mapping.items()}
        else:
            prog = program_tile(off, ext)
        if prog is None:
            t.tile_max.append(None)
            continue
        diffs = []
        for name, ch in mapping.items():
            diffs.append(absdiff(prog[name], ref[ch]))
            if keep is not None:
                keep(off, ext, name, ref[ch], prog[name])
        t.add_tile(diffs)
    return t


def verdict(numbers: Dict[str, float], limits: Dict[str, Optional[float]], missing: List[str],
            tile_max: List[Optional[int]]) -> Dict:
    """correct, failed tiles and the numbers beside their limits."""
    lines = {}
    ok = not missing
    for name, lim in limits.items():
        v = numbers.get(name)
        lines[name] = {"value": v, "limit": lim}
        if v is None or lim is None or v > lim:
            ok = False
    max_lim = limits.get("max_abs_lsb")
    failed = sum(1 for m in tile_max if m is None or (max_lim is not None and m > max_lim))
    if not ok and failed == 0:
        failed = len(tile_max)  # the tiles fail together (a mean over all of them)
    return dict(correct=ok, failed=failed, compared=len(tile_max), lines=lines,
                missing=missing)
