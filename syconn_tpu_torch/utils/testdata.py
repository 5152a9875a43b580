"""Synthetic EM world generator for tests, examples and benchmarks (the
port's copy of the host path of ``syconn_tpu/utils/testdata.py``).

A toy tissue volume with cells (Voronoi regions split into supervoxels),
tubular/blob organelles inside cells, synapse junctions at cell-cell
interfaces with sym/asym type maps, a noisy raw-EM-like image, and the
supervoxel adjacency graph; for one seed and shape byte-identical to the
JAX package's host world.

The dense fields of large worlds can come from the device generator
(``utils/testdata_device.py``); the world is then statistically equivalent
to the host world, not byte-identical. ``write_toy_world`` writes a world
as one HDF5 file per volume (through ``handler/compression.py``, which
needs h5py) and the supervoxel graph.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from scipy import ndimage

from .device import default_device

log = logging.getLogger("syconn_tpu_torch.testdata")

__all__ = ["auto_world_device", "generate_toy_world", "write_toy_world"]


AUTO_DEVICE_MVX = 32.0


def auto_world_device(shape, card):
    """The ``"auto"`` rule: ``card`` (a CUDA device, or None without one)
    for volumes of ``AUTO_DEVICE_MVX`` or more, else None (the host)."""
    big = float(np.prod([int(s) for s in shape])) >= AUTO_DEVICE_MVX * 1e6
    return torch.device(card) if big and card is not None else None


def _generator_device(device, shape):
    """The torch device of the dense fields, or None for the host path."""
    if device is False:
        return None
    if device == "auto":
        return auto_world_device(shape, "cuda" if torch.cuda.is_available() else None)
    return default_device(None if device is True else device)


def generate_toy_world(
    shape: Sequence[int] = (192, 192, 96),
    n_cells: int = 5,
    svs_per_cell: int = 3,
    seed: int = 0,
    scale: Sequence[int] = (10, 10, 20),
    device="auto",
) -> Dict[str, np.ndarray]:
    """Build the synthetic volume set.

    Returns dict with: raw (uint8), seg (uint64 supervoxels), mi/vc/sj
    (uint8 probability maps), sym/asym (uint8 maps), er/golgi (uint8 maps),
    rag ((N, 2) uint64 edges), cells (uint64 cell labels), sv2cell (dict).

    ``device``: ``False`` runs the host generator; ``True``, or a device
    (``"cuda"``, ``"cpu"``), evaluates the dense fields (Voronoi cells,
    supervoxels, organelle ellipsoids, synapse sprinkle, raw image) per voxel
    with PyTorch ops (``utils/testdata_device.py``; ``True`` means the card);
    ``"auto"`` takes the card for volumes of 32 MVx or more when one is
    attached, else the host (the JAX package's rule, without its relay link
    probe). The device world's labels equal the JAX package's device world;
    its raw image is statistically equivalent, not byte-identical. On the
    card, ``"_device"`` holds the seg, mi, vc and sj fields as they stay
    there (int32 and 0/255 uint8 tensors) for ``io.resident``.
    """
    gen_device = _generator_device(device, shape)
    if gen_device is not None:
        return _generate_toy_world_device(shape, n_cells, svs_per_cell, seed, scale, gen_device)
    log.info("world generator: host path (%.0f MVx)", np.prod(shape) / 1e6)
    rng = np.random.default_rng(seed)
    shape = tuple(int(s) for s in shape)
    scale = np.asarray(scale, np.float64)

    # ------------------------------------------------ cells: Voronoi regions
    n_seeds = n_cells
    seeds = np.stack(
        [rng.uniform(0.15 * s, 0.85 * s, n_seeds) for s in shape], axis=1
    )
    # anisotropy-aware nearest seed, running argmin (no (n_seeds, vol) alloc)
    axes = [np.arange(s, dtype=np.float32) * np.float32(scale[d] / scale[0])
            for d, s in enumerate(shape)]
    best_d = np.full(shape, np.inf, np.float32)
    cells = np.ones(shape, np.uint64)
    for i in range(n_seeds):
        s_nm = seeds[i] * scale / scale[0]
        di = (
            (axes[0] - np.float32(s_nm[0]))[:, None, None] ** 2
            + (axes[1] - np.float32(s_nm[1]))[None, :, None] ** 2
            + (axes[2] - np.float32(s_nm[2]))[None, None, :] ** 2
        )
        closer = di < best_d
        best_d = np.where(closer, di, best_d)
        cells[closer] = i + 1
    # carve extracellular gaps between cells (1-voxel boundaries -> 0)
    from ..ops.contacts import detect_seg_boundaries

    bdry = detect_seg_boundaries(cells.astype(np.uint32))
    cells[bdry] = 0

    # --------------------------------------- supervoxels: split each cell
    seg = np.zeros(shape, np.uint64)
    sv2cell = {}
    next_sv = 1
    # group voxel coords by cell with one stable argsort (8 full-volume
    # argwhere scans dominate at large shapes)
    flat = cells.ravel()
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat.astype(np.int64), minlength=n_seeds + 1)
    starts = np.cumsum(np.concatenate([[0], counts[:-1]]))
    strides = np.array([shape[1] * shape[2], shape[2], 1], np.int64)
    for c in range(1, n_seeds + 1):
        if counts[c] == 0:
            continue
        lin = order[starts[c] : starts[c] + counts[c]]
        coords = np.stack([lin // strides[0], (lin // strides[1]) % shape[1], lin % shape[2]], axis=1)
        k = min(svs_per_cell, max(1, len(coords) // 5000))
        centers = coords[rng.choice(len(coords), size=k, replace=False)]
        cf = coords.astype(np.float32)
        dd = np.zeros((len(coords), k), np.float32)
        for j in range(k):
            dd[:, j] = np.sum((cf - centers[j].astype(np.float32)[None]) ** 2, axis=1)
        assign = np.argmin(dd, axis=1)
        for j in range(k):
            sel = coords[assign == j]
            seg[sel[:, 0], sel[:, 1], sel[:, 2]] = next_sv
            sv2cell[next_sv] = c
            next_sv += 1

    # ------------------------------------------------------ rag (adjacency)
    pair_sets = []
    for a_sl, b_sl in (
        ((slice(None, -1), slice(None), slice(None)), (slice(1, None), slice(None), slice(None))),
        ((slice(None), slice(None, -1), slice(None)), (slice(None), slice(1, None), slice(None))),
        ((slice(None), slice(None), slice(None, -1)), (slice(None), slice(None), slice(1, None))),
    ):
        a = seg[a_sl].reshape(-1)
        b = seg[b_sl].reshape(-1)
        sel = (a != 0) & (b != 0) & (a != b)
        lo = np.minimum(a[sel], b[sel])
        hi = np.maximum(a[sel], b[sel])
        pair_sets.append(np.unique((lo << np.uint64(32)) | hi))
    packed = np.unique(np.concatenate(pair_sets)) if pair_sets else np.zeros(0, np.uint64)
    lo = (packed >> np.uint64(32)).astype(np.uint64)
    hi = (packed & np.uint64(0xFFFFFFFF)).astype(np.uint64)
    same_cell = np.array(
        [sv2cell[int(x)] == sv2cell[int(y)] for x, y in zip(lo, hi)], bool
    ) if len(packed) else np.zeros(0, bool)
    rag = np.stack([lo[same_cell], hi[same_cell]], axis=1).reshape(-1, 2)

    # -------------------------------------------------------- organelles
    def blobs_inside(n, r_vox, only_cells=None):
        out = np.zeros(shape, bool)
        placed = 0
        attempts = 0
        while placed < n and attempts < n * 20:
            attempts += 1
            p = np.array([rng.integers(r_vox, s - r_vox) for s in shape])
            cid = cells[p[0], p[1], p[2]]
            if cid == 0 or (only_cells is not None and cid not in only_cells):
                continue
            zz = max(1, r_vox // 2)
            sl = (
                slice(p[0] - r_vox, p[0] + r_vox + 1),
                slice(p[1] - r_vox, p[1] + r_vox + 1),
                slice(p[2] - zz, p[2] + zz + 1),
            )
            xx, yy, z2 = np.meshgrid(
                np.arange(-r_vox, r_vox + 1),
                np.arange(-r_vox, r_vox + 1),
                np.arange(-zz, zz + 1),
                indexing="ij",
            )
            ball = (xx / r_vox) ** 2 + (yy / r_vox) ** 2 + (z2 / max(zz, 1)) ** 2 <= 1.0
            region = out[sl]
            if region.shape != ball.shape:
                continue
            out[sl] |= ball & (cells[sl] == cid)
            placed += 1
        return out

    mi_mask = blobs_inside(max(6, n_cells * 3), 7)
    vc_mask = blobs_inside(max(8, n_cells * 4), 5)

    # er: tubular reticulum — short random walks from each cell seed,
    # dilated to ~2-voxel tubes, clipped to the cell
    er_mask = np.zeros(shape, bool)
    n_steps = max(120, int(np.prod(shape) ** (1 / 3)) * 4)
    sx, sy, sz = shape
    for c in range(1, n_seeds + 1):
        p = seeds[c - 1].astype(np.int64)
        px, py, pz = (int(np.clip(p[d], 1, shape[d] - 2)) for d in range(3))
        if cells[px, py, pz] != c:
            cc = np.argwhere(cells == c)
            if not len(cc):
                continue
            px, py, pz = (int(v) for v in cc[rng.integers(len(cc))])
        # pre-draw all steps; walk with scalar ints (np per-step ops dominate
        # generation time at large shapes otherwise)
        steps = rng.integers(-1, 2, (n_steps, 3))
        steps[rng.random(n_steps) >= 0.4, 2] = 0
        for dx, dy, dz in steps.tolist():
            qx = min(max(px + dx, 1), sx - 2)
            qy = min(max(py + dy, 1), sy - 2)
            qz = min(max(pz + dz, 1), sz - 2)
            if cells[qx, qy, qz] == c:
                px, py, pz = qx, qy, qz
            er_mask[px, py, pz] = True
    er_mask = ndimage.binary_dilation(er_mask, iterations=1) & (cells > 0)

    # golgi: stacks of flat discs (cisternae) inside cells
    golgi_mask = np.zeros(shape, bool)
    xx, yy = np.meshgrid(np.arange(-6, 7), np.arange(-6, 7), indexing="ij")
    disc = (xx / 6.0) ** 2 + (yy / 6.0) ** 2 <= 1.0
    for _ in range(n_cells * 2):
        p = np.array([rng.integers(8, s - 8) for s in shape])
        cid = cells[tuple(p)]
        if cid == 0:
            continue
        for dz in range(-3, 4, 2):  # 4 cisternae, 2-voxel spacing
            z = int(np.clip(p[2] + dz, 0, shape[2] - 1))
            sl = (slice(p[0] - 6, p[0] + 7), slice(p[1] - 6, p[1] + 7), z)
            golgi_mask[sl] |= disc & (cells[sl] == cid)

    # sj: at cell-cell interfaces — dilate boundary, keep between two cells
    interface = ndimage.binary_dilation(cells == 0, iterations=2)
    # pick contact patches: random subset of interface blobs
    sj_seed = rng.random(shape) < 0.004
    sj_mask = ndimage.binary_dilation(sj_seed & interface, iterations=3) & interface

    # sym/asym: split sj regions arbitrarily by blob-index parity
    sj_lab, n_sj = ndimage.label(sj_mask)
    sym_mask = sj_mask & (sj_lab % 2 == 0)
    asym_mask = sj_mask & (sj_lab % 2 == 1)

    # ------------------------------------------------------------- raw image
    raw = rng.normal(128, 15, shape)
    raw[cells == 0] -= 70  # dark membranes
    raw[mi_mask] -= 50
    raw[vc_mask] += 50
    raw[er_mask] -= 20  # ER membranes slightly dark
    raw[golgi_mask] -= 40  # stacked cisternae dark
    raw[sj_mask] -= 35  # synaptic densities are dark in EM
    raw = np.clip(raw, 0, 255).astype(np.uint8)

    to_prob = lambda m: (m.astype(np.uint8) * 255)
    return {
        "raw": raw,
        "seg": seg,
        "cells": cells,
        "mi": to_prob(mi_mask),
        "vc": to_prob(vc_mask),
        "sj": to_prob(sj_mask),
        "sym": to_prob(sym_mask),
        "asym": to_prob(asym_mask),
        "er": to_prob(er_mask),
        "golgi": to_prob(golgi_mask),
        "rag": rag,
        "sv2cell": sv2cell,
    }


def _generate_toy_world_device(shape, n_cells, svs_per_cell, seed, scale, device):
    """Device-path world: dense fields on ``device``, sparse pieces (ER
    walks, golgi discs, sym/asym split, RAG) on the host."""
    from .testdata_device import generate_dense_fields_device

    rng = np.random.default_rng(seed)
    shape = tuple(int(s) for s in shape)
    scale = np.asarray(scale, np.float64)
    aniso = scale / scale[0]

    seeds = np.stack([rng.uniform(0.15 * s, 0.85 * s, n_cells) for s in shape], axis=1)

    def cell_of(p):
        d = np.sum(((p[None] - seeds) * aniso[None]) ** 2, axis=1)
        return int(np.argmin(d)) + 1

    # supervoxel centers: rejection-sampled points inside each cell
    svc, svc_cell, sv2cell = [], [], {}
    next_sv = 1
    for c in range(1, n_cells + 1):
        placed = 0
        while placed < svs_per_cell:
            p = np.array([rng.uniform(0, s) for s in shape])
            if cell_of(p) != c:
                continue
            svc.append(p)
            svc_cell.append(c)
            sv2cell[next_sv] = c
            next_sv += 1
            placed += 1

    def sample_blobs(n, r_vox):
        out = []
        attempts = 0
        while len(out) < n and attempts < n * 20:
            attempts += 1
            p = np.array([rng.integers(r_vox, s - r_vox) for s in shape], np.float64)
            c = cell_of(p)
            zz = max(1, r_vox // 2)
            out.append([p[0], p[1], p[2], float(r_vox), float(zz), float(c)])
        return np.asarray(out, np.float32).reshape(-1, 6)

    mi_blobs = sample_blobs(max(6, n_cells * 3), 7)
    vc_blobs = sample_blobs(max(8, n_cells * 4), 5)

    dense = generate_dense_fields_device(
        shape, seeds, np.asarray(svc), np.asarray(svc_cell, np.int32),
        mi_blobs, vc_blobs, scale, seed, device=device,
    )
    seg16 = dense["seg"]
    lut = np.concatenate([np.zeros(1, np.uint64), np.asarray(svc_cell, np.uint64)])
    cells = lut[seg16]
    mi_mask, vc_mask, sj_mask = dense["mi"], dense["vc"], dense["sj"]
    raw = dense["raw"].astype(np.int16)

    # ------------------------------ sparse host pieces (O(objects) work)
    er_seed = np.zeros(shape, bool)
    n_steps = max(120, int(np.prod(shape) ** (1 / 3)) * 4)
    sx, sy, sz = shape
    for c in range(1, n_cells + 1):
        p = seeds[c - 1].astype(np.int64)
        px, py, pz = (int(np.clip(p[d], 1, shape[d] - 2)) for d in range(3))
        steps = rng.integers(-1, 2, (n_steps, 3))
        steps[rng.random(n_steps) >= 0.4, 2] = 0
        for dx, dy, dz in steps.tolist():
            qx = min(max(px + dx, 1), sx - 2)
            qy = min(max(py + dy, 1), sy - 2)
            qz = min(max(pz + dz, 1), sz - 2)
            if cells[qx, qy, qz] == c:
                px, py, pz = qx, qy, qz
            er_seed[px, py, pz] = True
    er_mask = ndimage.binary_dilation(er_seed, iterations=1) & (cells > 0)

    golgi_mask = np.zeros(shape, bool)
    xx, yy = np.meshgrid(np.arange(-6, 7), np.arange(-6, 7), indexing="ij")
    disc = (xx / 6.0) ** 2 + (yy / 6.0) ** 2 <= 1.0
    for _ in range(n_cells * 2):
        p = np.array([rng.integers(8, s - 8) for s in shape])
        cid = cells[tuple(p)]
        if cid == 0:
            continue
        for dz in range(-3, 4, 2):
            z = int(np.clip(p[2] + dz, 0, shape[2] - 1))
            sl = (slice(p[0] - 6, p[0] + 7), slice(p[1] - 6, p[1] + 7), z)
            golgi_mask[sl] |= disc & (cells[sl] == cid)

    raw[er_mask] -= 20
    raw[golgi_mask] -= 40
    raw = np.clip(raw, 0, 255).astype(np.uint8)

    sj_lab, _ = ndimage.label(sj_mask)
    sym_mask = sj_mask & (sj_lab % 2 == 0)
    asym_mask = sj_mask & (sj_lab % 2 == 1)

    # RAG from the narrow (uint16) labels: 4x less memory traffic than
    # scanning the uint64 volume
    pair_sets = []
    for a_sl, b_sl in (
        ((slice(None, -1), slice(None), slice(None)), (slice(1, None), slice(None), slice(None))),
        ((slice(None), slice(None, -1), slice(None)), (slice(None), slice(1, None), slice(None))),
        ((slice(None), slice(None), slice(None, -1)), (slice(None), slice(None), slice(1, None))),
    ):
        a = seg16[a_sl].reshape(-1)
        b = seg16[b_sl].reshape(-1)
        sel = (a != 0) & (b != 0) & (a != b)
        lo32 = np.minimum(a[sel], b[sel]).astype(np.uint32)
        hi32 = np.maximum(a[sel], b[sel]).astype(np.uint32)
        pair_sets.append(np.unique((lo32 << np.uint32(16)) | hi32))
    packed = np.unique(np.concatenate(pair_sets)) if pair_sets else np.zeros(0, np.uint32)
    lo = (packed >> np.uint32(16)).astype(np.uint64)
    hi = (packed & np.uint32(0xFFFF)).astype(np.uint64)
    seg = seg16.astype(np.uint64)
    same_cell = (
        np.array([sv2cell[int(x)] == sv2cell[int(y)] for x, y in zip(lo, hi)], bool)
        if len(packed) else np.zeros(0, bool)
    )
    rag = np.stack([lo[same_cell], hi[same_cell]], axis=1).reshape(-1, 2)

    dev = dense["_device"]
    dev_out = {}
    if dev:
        # the generated fields are still on the card: hand them to the caller
        # so that the resident store registers them without an upload. raw
        # is left out (the host darkens it for er/golgi above); sym/asym come
        # from the host labelling.
        dev_out = {"seg": dev["seg"]}
        for bit, co in ((1, "mi"), (2, "vc"), (4, "sj")):
            dev_out[co] = ((dev["masks"] & bit) > 0).to(torch.uint8) * 255
        del dev

    to_prob = lambda m: (m.astype(np.uint8) * 255)
    return {
        "_device": dev_out,
        "raw": raw,
        "seg": seg,
        "cells": cells,
        "mi": to_prob(mi_mask),
        "vc": to_prob(vc_mask),
        "sj": to_prob(sj_mask),
        "sym": to_prob(sym_mask),
        "asym": to_prob(asym_mask),
        "er": to_prob(er_mask),
        "golgi": to_prob(golgi_mask),
        "rag": rag,
        "sv2cell": sv2cell,
    }


def write_toy_world(h5_dir: str, world: Optional[dict] = None, **kw) -> dict:
    """Write a toy world (generated from ``kw`` where ``world`` is None) as
    ``<name>.h5`` per volume (one dataset named like the file) and the
    supervoxel graph ``neuron_rag.bz2``, for external tools;
    ``examples/start.py`` builds its world in memory and does not read this
    layout. Returns the world."""
    from ..handler.compression import save_to_h5py
    from ..io.graph import save_svgraph

    os.makedirs(h5_dir, exist_ok=True)
    if world is None:
        world = generate_toy_world(**kw)
    for name in ["raw", "seg", "mi", "vc", "sj", "sym", "asym", "er", "golgi"]:
        save_to_h5py({name: world[name]}, os.path.join(h5_dir, f"{name}.h5"))
    save_svgraph(world["rag"], os.path.join(h5_dir, "neuron_rag.bz2"))
    return world
