"""Device synthetic-world generation (counterpart of
``syconn_tpu/utils/testdata_device.py``), as PyTorch ops.

The host generator (``utils/testdata.py``) is O(volume) numpy; at benchmark
scales it dominates the pipeline's preparation step. The world is
*analytic* (Voronoi cells of seed points, supervoxels as per-cell Voronoi
of sub-centers, ellipsoid organelles, a hashed sprinkle of synapse seeds),
so every dense field is evaluated per voxel on the device: one x-chunk
(+ halo for the neighbourhood ops) at a time, each chunk copied to the host
while the next one computes, and kept on the device for ``io.resident``.

Only the sparse/irregular pieces stay on the host (ER random walks, golgi
disc stamping, connected-component parity for sym/asym, RAG extraction):
they are O(objects), not O(volume).

For the same inputs the label fields (cells, supervoxels, mi, vc, sj) equal
the JAX package's: the distance sums are evaluated in its order in float32,
ties in ``argmin`` go to the first index in both, and the uint32 hash is
computed in int64 with every product and xor taken modulo 2**32. The raw
image's noise comes from a ``torch.Generator`` seeded from ``seed`` (JAX's
``jax.random.normal`` draws cannot be reproduced), so the raw image is
statistically equivalent to the JAX package's, not equal.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Sequence

import numpy as np
import torch

from .device import DeviceLike, default_device

__all__ = ["generate_dense_fields_device"]

log = logging.getLogger("syconn_tpu_torch.testdata")

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for int64 ``h`` in [0, 2**32): the product in two
    16-bit halves of ``c``, so that no int64 intermediate overflows."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash01(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, salt: int) -> torch.Tensor:
    """Deterministic per-voxel uniform in [0, 1) from global coordinates:
    chunk-border consistent (unlike per-chunk random streams). ``x``, ``y``,
    ``z``: int64 coordinates (non-negative or not: they are taken modulo
    2**32, as JAX's cast to uint32 takes them)."""
    h = (_mul32(x & _M32, 73856093) ^ _mul32(y & _M32, 19349663)
         ^ _mul32(z & _M32, 83492791) ^ (salt & _M32))
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h.to(torch.float32) * (2.0 ** -32)


def _dilate6(m: torch.Tensor, iterations: int) -> torch.Tensor:
    """6-neighbourhood binary dilation (scipy's default cross structure),
    zero-padded borders."""
    for _ in range(iterations):
        out = m.clone()
        out[1:] |= m[:-1]
        out[:-1] |= m[1:]
        out[:, 1:] |= m[:, :-1]
        out[:, :-1] |= m[:, 1:]
        out[:, :, 1:] |= m[:, :, :-1]
        out[:, :, :-1] |= m[:, :, 1:]
        m = out
    return m


def _sq_dist(X, Y, Z, pts: torch.Tensor) -> torch.Tensor:
    """(cx, cy, cz, K) float32 squared distances to ``pts`` (K, 3), summed
    as the JAX package writes them: ``(dx**2 + dy**2) + dz**2``."""
    dx = X[..., None] - pts[:, 0]
    dy = Y[..., None] - pts[:, 1]
    dz = Z[..., None] - pts[:, 2]
    return (dx * dx + dy * dy) + dz * dz


def _blob_mask(cells: torch.Tensor, offset, blobs: np.ndarray) -> torch.Tensor:
    """Voxels inside an ellipsoid ``blobs[i]`` = (cx, cy, cz, rxy, rz, cell)
    (voxel units) and in its cell, one blob at a time over its bounding box.

    The test ``(dx/rxy)**2 + (dy/rxy)**2 + (dz/rz)**2 <= 1`` is evaluated as
    ``(dx**2 + dy**2) * rz**2 + dz**2 * rxy**2 <= rxy**2 * rz**2`` in float64,
    exact for the generator's integer centers and radii. The JAX package
    evaluates the quotients in float32, where XLA:CPU contracts one of the
    first two squares into a fused multiply-add, and which one depends on
    the compiled program: on the ellipsoid's surface lattice points with
    (dx, dy) = (+-3, +-4) or (+-4, +-3) of a vc blob (rxy 5), where the exact
    value is 1, its answer differs between compilations; everywhere else it
    agrees with this one."""
    dev = cells.device
    out = torch.zeros(cells.shape, dtype=torch.bool, device=dev)
    for b in np.asarray(blobs, np.float64).reshape(-1, 6):
        c, rxy, rz, cell = b[:3], b[3], b[4], int(b[5])
        r = np.array([rxy, rxy, rz])
        lo = np.maximum(np.floor(c - r).astype(np.int64) - np.asarray(offset), 0)
        hi = np.minimum(np.ceil(c + r).astype(np.int64) + 1 - np.asarray(offset),
                        cells.shape)
        if np.any(hi <= lo):
            continue
        ax = [(torch.arange(int(lo[d]), int(hi[d]), dtype=torch.float64, device=dev)
               + float(offset[d]) - float(c[d])) ** 2 for d in range(3)]
        q = ((ax[0][:, None, None] + ax[1][None, :, None]) * (rz * rz)
             + ax[2][None, None, :] * (rxy * rxy))
        sl = tuple(slice(int(lo[d]), int(hi[d])) for d in range(3))
        out[sl] |= (q <= rxy * rxy * rz * rz) & (cells[sl] == cell)
    return out


def _gen_chunk(offset, gen, seeds_nm, svc_nm, svc_cell, mi_blobs, vc_blobs, aniso,
               chunk_shape, halo: int, salt: int, sj_p: float, noise_sd: float,
               noise_mean: float):
    """One haloed x-chunk of the dense fields: ``(seg, packed, raw)`` of its
    core, seg int32 (supervoxel ids 1..M), packed uint8 (bit 0 mi, 1 vc,
    2 sj), raw uint8."""
    dev = seeds_nm.device
    cx, cy, cz = chunk_shape
    gx = offset[0] + torch.arange(cx, dtype=torch.int64, device=dev)
    gy = offset[1] + torch.arange(cy, dtype=torch.int64, device=dev)
    gz = offset[2] + torch.arange(cz, dtype=torch.int64, device=dev)
    X = (gx.to(torch.float32) * aniso[0])[:, None, None]
    Y = (gy.to(torch.float32) * aniso[1])[None, :, None]
    Z = (gz.to(torch.float32) * aniso[2])[None, None, :]

    # cells: nearest seed (anisotropy-aware), 1-based
    cells = torch.argmin(_sq_dist(X, Y, Z, seeds_nm), dim=-1).to(torch.int32) + 1

    # extracellular carve: 6-neighbour label change -> 0
    bdry = torch.zeros(cells.shape, dtype=torch.bool, device=dev)
    for ax in range(3):
        d = cells.narrow(ax, 1, cells.shape[ax] - 1) != cells.narrow(ax, 0, cells.shape[ax] - 1)
        n = cells.shape[ax] - 1
        bdry.narrow(ax, 1, n).logical_or_(d)
        bdry.narrow(ax, 0, n).logical_or_(d)
    cells = torch.where(bdry, torch.zeros_like(cells), cells)

    # supervoxels: nearest sv center OF THE VOXEL'S CELL
    dsv = _sq_dist(X, Y, Z, svc_nm)
    dsv = torch.where(svc_cell == cells[..., None], dsv,
                      torch.tensor(1e30, dtype=torch.float32, device=dev))
    seg = torch.where(cells > 0, torch.argmin(dsv, dim=-1).to(torch.int32) + 1,
                      torch.zeros_like(cells))
    del dsv

    mi = _blob_mask(cells, offset, mi_blobs)
    vc = _blob_mask(cells, offset, vc_blobs)

    # synapse junctions: hashed sprinkle on the 2-dilated membrane interface
    interface = _dilate6(cells == 0, 2)
    shape = (cx, cy, cz)
    h = _hash01(gx[:, None, None].expand(shape), gy[None, :, None].expand(shape),
                gz[None, None, :].expand(shape), salt)
    sj_seed = (h < torch.tensor(sj_p, dtype=torch.float32, device=dev)) & interface
    sj = _dilate6(sj_seed, 3) & interface

    # raw EM image
    noise = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
    raw = noise * noise_sd + noise_mean
    raw = raw - 70.0 * (cells == 0) - 50.0 * mi + 50.0 * vc - 35.0 * sj
    raw_u8 = torch.clamp(torch.round(raw), 0, 255).to(torch.uint8)

    core = (slice(halo, cx - halo), slice(halo, cy - halo), slice(halo, cz - halo))
    packed = (mi[core].to(torch.uint8) | (vc[core].to(torch.uint8) << 1)
              | (sj[core].to(torch.uint8) << 2))
    return seg[core].contiguous(), packed.contiguous(), raw_u8[core].contiguous()


def generate_dense_fields_device(
    shape: Sequence[int],
    seeds: np.ndarray,
    svc: np.ndarray,
    svc_cell: np.ndarray,
    mi_blobs: np.ndarray,
    vc_blobs: np.ndarray,
    scale: np.ndarray,
    seed: int,
    chunk_x: int = 64,
    halo: int = 8,
    sj_p: float = 0.004,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """Generate the dense analytic fields on ``device`` (None: the card)
    chunk by chunk and copy them to the host.

    Returns seg (uint16, sv labels 1..M), mi/vc/sj (bool), raw (uint8) and
    ``"_device"``: on a CUDA device the label fields as they stay on it
    (``seg`` int32, ``masks`` uint8 with bit 0 mi, 1 vc, 2 sj), for
    ``io.resident`` to register without an upload; empty on the CPU. (The
    raw image stays on the host: the world darkens it there for ER and
    golgi.)
    """
    dev = default_device(device)
    shape = tuple(int(s) for s in shape)
    aniso = (np.asarray(scale, np.float64) / scale[0]).astype(np.float32)
    seeds_nm = (np.asarray(seeds, np.float32) * aniso[None]).astype(np.float32)
    svc_nm = (np.asarray(svc, np.float32) * aniso[None]).astype(np.float32)
    svc_cell = np.asarray(svc_cell, np.int32)
    mi_blobs = np.asarray(mi_blobs, np.float32).reshape(-1, 6)
    vc_blobs = np.asarray(vc_blobs, np.float32).reshape(-1, 6)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in (
        ("seeds", seeds_nm), ("svc", svc_nm), ("svc_cell", svc_cell), ("aniso", aniso))}

    seg = np.zeros(shape, np.uint16)
    masks = np.zeros(shape, np.uint8)
    raw = np.zeros(shape, np.uint8)
    n_chunks = -(-shape[0] // chunk_x)
    cshape = (chunk_x + 2 * halo, shape[1] + 2 * halo, shape[2] + 2 * halo)
    gen = torch.Generator(device=dev)
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    dev_chunks = []
    inflight = []

    def drain(entry):
        x0, x1, host = entry
        if on_card:
            host[3].synchronize()
        seg[x0:x1] = host[0].numpy()[: x1 - x0].astype(np.uint16)
        masks[x0:x1] = host[1].numpy()[: x1 - x0]
        raw[x0:x1] = host[2].numpy()[: x1 - x0]

    for ci in range(n_chunks):
        x0 = ci * chunk_x
        x1 = min(shape[0], x0 + chunk_x)
        gen.manual_seed((int(seed) * 1_000_003 + ci) & 0x7FFFFFFFFFFFFFFF)
        fields = _gen_chunk((x0 - halo, -halo, -halo), gen, t["seeds"], t["svc"],
                            t["svc_cell"], mi_blobs, vc_blobs, t["aniso"], cshape, halo,
                            int(seed) & 0x7FFFFFFF, float(sj_p), 15.0, 128.0)
        if on_card:
            # copy to pinned host buffers behind the compute of the next chunk
            host = [torch.empty(f.shape, dtype=f.dtype, pin_memory=True) for f in fields]
            for hb, f in zip(host, fields):
                hb.copy_(f, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            host.append(ev)
            dev_chunks.append(tuple(f[: x1 - x0] for f in fields[:2]))
        else:
            host = list(fields)
        inflight.append((x0, x1, host))
        if len(inflight) > 2:
            drain(inflight.pop(0))
        if ci % 4 == 3:
            log.info("device world generation: %d/%d x-chunks (%.1f MVx/s)", ci + 1, n_chunks,
                     (x1 * shape[1] * shape[2]) / max(time.perf_counter() - t0, 1e-9) / 1e6)
    while inflight:
        drain(inflight.pop(0))
    device_fields = {}
    if on_card:
        # one field at a time, to bound the transient working set
        for name, ix in (("seg", 0), ("masks", 1)):
            device_fields[name] = torch.cat([c[ix] for c in dev_chunks], dim=0)
        del dev_chunks
    return {"seg": seg, "mi": (masks & 1) > 0, "vc": (masks & 2) > 0, "sj": (masks & 4) > 0,
            "raw": raw, "_device": device_fields}
