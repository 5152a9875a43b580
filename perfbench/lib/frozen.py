"""The benchmark's frozen yardstick: published peaks, the dense U-Net's
forward FLOPs, and the operations and bytes of each conv kernel launch.

Copied from the program so that a later change to the program cannot move
the yardstick: ``unet_flops`` from ``syconn_tpu_torch/models/unet_engine.py``
and the per-launch counts of ``chip_smoke.py``'s kernel bounds (input bytes
counted once, output written once). Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

# NVIDIA H100 SXM data sheet, dense rates: bf16 tensor cores, HBM3
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# device kernels that run the 3x3x3 convolutions (``ops/csrc/conv3d_wgmma.cu``
# and ``ops/csrc/conv3d.cu``), matched as substrings of the traced names
CONV_KERNELS = ("conv3d_wgmma_kernel", "conv3d_kernel")


def _prod(v) -> int:
    out = 1
    for x in v:
        out *= int(x)
    return out


def unet_flops(arch: dict, in_shape: Sequence[int]) -> float:
    """Forward FLOPs of one (B, X, Y, Z) input: 2*27*S*Cin*Cout per 3x3x3
    conv, transposes counted at input (half) resolution, the head at
    2*S*Cin*Cout."""
    B, X, Y, Z = (int(v) for v in in_shape[:4])
    p = tuple(int(v) for v in arch["patch"])
    feats = tuple(int(f) for f in arch["features"])
    strides = [tuple(int(v) for v in s) for s in arch["strides"]]
    s = [X // p[0], Y // p[1], Z // p[2]]
    pvox = p[0] * p[1] * p[2]
    cin = pvox
    total = 0.0
    sizes = []
    for i, f in enumerate(feats):
        S = B * s[0] * s[1] * s[2]
        total += 2 * 27 * S * cin * f + 2 * 27 * S * f * f
        sizes.append((tuple(s), f))
        if i < len(feats) - 1:
            st = strides[i]
            s = [s[0] // st[0], s[1] // st[1], s[2] // st[2]]
            S2 = B * s[0] * s[1] * s[2]
            total += 2 * 27 * S2 * f * feats[i + 1]
            cin = feats[i + 1]
    for i in reversed(range(len(feats) - 1)):
        up_shape, f = sizes[i]
        S = B * up_shape[0] * up_shape[1] * up_shape[2]
        sp = _prod(strides[i])
        total += 2 * 27 * (S // sp) * feats[i + 1] * f
        total += 2 * 27 * S * (2 * f) * f + 2 * 27 * S * f * f
    S = B * sizes[0][0][0] * sizes[0][0][1] * sizes[0][0][2]
    total += 2 * S * feats[0] * (int(arch["n_classes"]) * pvox)
    return float(total)


def conv_launches(arch: dict, in_shape: Sequence[int]) -> List[Dict]:
    """The conv launches of one engine forward of a (B, X, Y, Z) input, in
    order, each with its FLOPs and bytes: every 3x3x3 SAME conv (the last
    one with the fused head), each stride-2 conv and each transpose."""
    B, X, Y, Z = (int(v) for v in in_shape[:4])
    p = tuple(int(v) for v in arch["patch"])
    feats = tuple(int(f) for f in arch["features"])
    strides = [tuple(int(v) for v in s) for s in arch["strides"]]
    pvox = _prod(p)
    nh_last = int(arch["n_classes"]) * pvox
    s = (X // p[0], Y // p[1], Z // p[2])
    out: List[Dict] = []

    def same(S, cin, cout, nh=0):
        flops = 2 * 27 * S * cin * cout + 2 * S * cout * nh
        in_b = S * cin * 2 + 27 * cin * cout * 2 + cout * 2 + (cout * nh * 4 if nh else 0)
        out_b = S * (4 * nh if nh else 2 * cout)
        out.append(dict(kind="same", flops=flops, bytes=in_b + out_b))

    def down(S_in, cin, cout):
        s_out = S_in // 8
        out.append(dict(kind="down", flops=2 * 27 * s_out * cin * cout,
                        bytes=S_in * cin * 2 + 27 * cin * cout * 2 + cout * 2 + s_out * 2 * cout))

    def up(S_in, cin, cout):
        out.append(dict(kind="up", flops=2 * 27 * S_in * cin * cout,
                        bytes=S_in * cin * 2 + 27 * cin * cout * 2 + cout * 2
                        + 8 * S_in * 2 * cout))

    sizes = []
    cin = pvox
    for i, f in enumerate(feats):
        S = B * _prod(s)
        same(S, cin, f)
        same(S, f, f)
        sizes.append(S)
        if i < len(feats) - 1:
            down(S, f, feats[i + 1])
            s = tuple(a // b for a, b in zip(s, strides[i]))
            cin = feats[i + 1]
    for i in reversed(range(len(feats) - 1)):
        f = feats[i]
        up(sizes[i + 1], feats[i + 1], f)
        same(sizes[i], 2 * f, f)
        same(sizes[i], f, f, nh_last if i == 0 else 0)
    return out


def launch_bound_s(launch: Dict) -> float:
    """Least time of one launch on one card: operations over the bf16 peak
    or bytes over the HBM peak, whichever is larger."""
    return max(launch["flops"] / PEAK_FLOPS, launch["bytes"] / PEAK_BYTES)


def forward_bound_s(arch: dict, in_shape: Sequence[int]) -> float:
    return sum(launch_bound_s(x) for x in conv_launches(arch, in_shape))
