"""Inputs made from ``--seed``: the U-Net's weights and an EM-like volume.

Both are drawn on the device by a ``torch.Generator`` in a few large calls,
so the same seed gives the same inputs; each use of the seed draws from its
own stream (:func:`stream_seed`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one named use of the run's seed."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), stream]).generate_state(
        1, np.uint64)[0]) >> 1


def param_leaves(arch: dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str]]:
    """Every parameter of the U-Net in flax layout: (path, shape, kind),
    kind one of ``kernel``, ``bias``, ``ln_scale``, ``ln_bias``, ``head``."""
    feats = [int(f) for f in arch["features"]]
    pvox = int(np.prod(arch["patch"]))
    depth = len(feats)
    out = []

    def conv(path, cin, cout, k=3):
        out.append((path + ("kernel",), (k, k, k, cin, cout), "head" if k == 1 else "kernel"))
        out.append((path + ("bias",), (cout,), "bias"))

    def block(name, cin, f):
        for j in range(2):
            conv((name, f"Conv_{j}"), cin if j == 0 else f, f)
            out.append(((name, f"LayerNorm_{j}", "scale"), (f,), "ln_scale"))
            out.append(((name, f"LayerNorm_{j}", "bias"), (f,), "ln_bias"))

    cin = pvox
    for i, f in enumerate(feats):
        block(f"ConvBlock_{i}", cin, f)
        if i < depth - 1:
            conv((f"Conv_{i}",), f, feats[i + 1])
            cin = feats[i + 1]
    for k, i in enumerate(reversed(range(depth - 1))):
        conv((f"ConvTranspose_{k}",), feats[i + 1], feats[i])
        block(f"ConvBlock_{depth + k}", 2 * feats[i], feats[i])
    conv(("head",), feats[0], int(arch["n_classes"]) * pvox, k=1)
    return out


def make_params(arch: dict, seed: int, device) -> Dict:
    """Seeded float32 weights as a flax-layout tree of device tensors: one
    normal draw for all of them, kernels at 1/sqrt(fan-in) (lecun normal),
    biases and LayerNorm offsets at 0.1, LayerNorm scales at 1 +- 0.1."""
    leaves = param_leaves(arch)
    sizes = [int(np.prod(s)) for _, s, _ in leaves]
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    tree: Dict = {}
    pos = 0
    for (path, shape, kind), n in zip(leaves, sizes):
        v = flat[pos:pos + n].view(shape)
        pos += n
        if kind in ("kernel", "head"):
            v = v / math.sqrt(int(np.prod(shape[:-1])))
        elif kind == "ln_scale":
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return tree


def host_tree(tree: Dict) -> Dict:
    """The same tree with numpy leaves (the program's ``params`` argument),
    copied to the host in one transfer."""
    leaves = []

    def walk(node):
        for v in node.values():
            if isinstance(v, dict):
                walk(v)
            else:
                leaves.append(v)

    walk(tree)
    host = torch.cat([v.reshape(-1) for v in leaves]).cpu()
    parts = iter(torch.split(host, [v.numel() for v in leaves]))

    def build(node):
        return {k: build(v) if isinstance(v, dict) else next(parts).view(v.shape).numpy()
                for k, v in node.items()}

    return build(tree)


@torch.no_grad()
def em_volume(shape: Sequence[int], seed: int, device, slab: int = 128) -> torch.Tensor:
    """An EM-like uint8 volume (x, y, z): bright cell interiors, dark
    membranes at the zero set of a smooth random field, darker organelle-like
    blobs, and voxel noise. Cells are ~20-40 voxels across in x and y and
    half that in z (10 x 10 x 20 nm voxels). Drawn in x-slabs."""
    shape = tuple(int(s) for s in shape)
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 2))
    cell = [max(2, -(-s // c) + 3) for s, c in zip(shape, (24, 24, 12))]
    blob = [max(2, -(-s // c) + 3) for s, c in zip(shape, (8, 8, 4))]
    f_cell = torch.randn(cell, generator=g, device=device)
    f_blob = torch.randn(blob, generator=g, device=device)
    out = torch.empty(shape, dtype=torch.uint8, device=device)
    for x0 in range(0, shape[0], slab):
        x1 = min(x0 + slab, shape[0])
        fc = _upsample(f_cell, shape, (24, 24, 12), x0, x1)
        fb = _upsample(f_blob, shape, (8, 8, 4), x0, x1)
        noise = torch.randn((x1 - x0,) + shape[1:], generator=g, device=device)
        v = 175.0 - 120.0 * torch.exp(-(fc / 0.12) ** 2) - 60.0 * torch.sigmoid(6.0 * (fb - 1.2))
        v = v + 12.0 * noise
        out[x0:x1] = v.clamp_(0.0, 255.0).round_().to(torch.uint8)
    return out


def _upsample(coarse: torch.Tensor, shape, step, x0: int, x1: int) -> torch.Tensor:
    """Rows x0:x1 of the trilinear interpolation of a coarse grid whose
    points lie ``step`` voxels apart."""
    def axis(n, s, lo=0, hi=None):
        hi = n if hi is None else hi
        t = torch.arange(lo, hi, device=coarse.device, dtype=torch.float32) / s
        i0 = t.floor().long()
        return i0, (t - i0).view(-1)

    ix, fx = axis(shape[0], step[0], x0, x1)
    iy, fy = axis(shape[1], step[1])
    iz, fz = axis(shape[2], step[2])
    c = coarse
    v = (c[ix] * (1 - fx).view(-1, 1, 1) + c[ix + 1] * fx.view(-1, 1, 1))
    v = v[:, iy] * (1 - fy).view(1, -1, 1) + v[:, iy + 1] * fy.view(1, -1, 1)
    v = v[:, :, iz] * (1 - fz).view(1, 1, -1) + v[:, :, iz + 1] * fz.view(1, 1, -1)
    return v
