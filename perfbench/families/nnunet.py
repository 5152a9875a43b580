"""Model family ``nnunet``: nnU-Net's 3d_fullres ``PlainConvUNet`` (Isensee
et al., Nat. Methods 18:203-211, 2021), run by the port as
``syconn_tpu_torch.models.nnunet.NNUNet`` on ``models/nnunet_engine.py``: the
wgmma conv kernels (SAME, the (1, 1)-padded stride-2 conv, the k2 s2
transpose, Cout 320 split over two blocks) and the instance-norm kernels of
``ops/csrc/instnorm.cu``.

A configuration's ``arch`` holds ``features``, ``strides``, ``kernel``,
``convs_per_stage``, ``convs_per_stage_decoder``, ``norm_eps``,
``leaky_slope``, ``in_channels``, ``n_classes``, ``intensity_mean`` and
``intensity_std``. The weights, the plain reference
(``reference/nnunet.py``) and the counts below are this file's and that
one's: nothing here reads the program's arithmetic.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench.lib import frozen
from perfbench.lib.inputs import stream_seed
from perfbench.reference import nnunet as reference

# the 3x3x3 convs and the k2 transposes run in the wgmma kernel's
# instantiations (``ops/csrc/conv3d_wgmma.cu``), the U-Net's conv kernels
CONV_KERNELS = frozen.CONV_KERNELS
# the instance norm's two kernels (``ops/csrc/instnorm.cu``)
NORM_KERNELS = ("instnorm_stats_kernel", "instnorm_apply_kernel")


def make_params(arch: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights as a flat dict of device tensors, one normal
    draw for all of them: conv and transposed-conv kernels He normal
    (sqrt(2 / fan-in), nnU-Net's init for LeakyReLU), the head lecun normal,
    biases and norm shifts at 0.1, norm scales 1 +- 0.1."""
    leaves = reference.param_shapes(arch)
    sizes = [int(np.prod(s)) for _, s, _ in leaves]
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 21))
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out, pos = {}, 0
    for (name, shape, kind), n in zip(leaves, sizes):
        v = flat[pos:pos + n].view(shape)
        pos += n
        if kind == "conv":
            v = v * math.sqrt(2.0 / int(np.prod(shape[1:])))
        elif kind == "transpconv":
            v = v * math.sqrt(2.0 / (shape[0] * 8))
        elif kind == "head":
            v = v / math.sqrt(shape[1])
        elif kind == "norm_weight":
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        out[name] = v
    return out


def program_model(arch: dict, params: Dict[str, torch.Tensor], device):
    """The port's ``NNUNet`` and its flat dict of numpy arrays (PyTorch's
    layouts, the names of ``param_shapes``), copied to the host in one
    transfer."""
    from syconn_tpu_torch.models.nnunet import NNUNet

    names = list(params)
    host = torch.cat([params[n].reshape(-1) for n in names]).cpu()
    parts = torch.split(host, [params[n].numel() for n in names])
    tree = {n: p.view(params[n].shape).numpy() for n, p in zip(names, parts)}
    return NNUNet.from_arch(arch), tree


def reference_forward(arch: dict, params: Dict[str, torch.Tensor], window: torch.Tensor,
                      precision: str = "f32") -> torch.Tensor:
    """window (X, Y, Z) uint8 -> uint8 probabilities (C, X, Y, Z)."""
    return reference.forward(arch, params, window, precision)


def _sizes(arch: dict, in_shape: Sequence[int]) -> List[int]:
    """Positions of each stage's output for a (B, X, Y, Z) input (extents
    multiples of the strides' product)."""
    B, X, Y, Z = (int(v) for v in in_shape[:4])
    s = [X, Y, Z]
    out = []
    for st in arch["strides"]:
        s = [a // int(b) for a, b in zip(s, st)]
        out.append(B * s[0] * s[1] * s[2])
    return out


def flops(arch: dict, in_shape: Sequence[int]) -> float:
    """Forward FLOPs of one (B, X, Y, Z) input: 2*27*S_out*Cin*Cout for each
    3x3x3 conv (the stem at its one input channel), 2*S_in*Cin*8*Cout for
    each k2 transpose, 2*S*f_0*C for the head."""
    f = [int(v) for v in arch["features"]]
    S = _sizes(arch, in_shape)
    cin = int(arch["in_channels"])
    total = 0
    for i, c in enumerate(f):
        total += 2 * 27 * S[i] * (cin * c + c * c)
        cin = c
    for k in range(len(f) - 1):
        i = len(f) - 2 - k
        total += 2 * S[i + 1] * f[i + 1] * 8 * f[i] + 2 * 27 * S[i] * 3 * f[i] * f[i]
    total += 2 * S[0] * f[0] * int(arch["n_classes"])
    return float(total)


def conv_launches(arch: dict, in_shape: Sequence[int]) -> List[Dict]:
    """The conv launches of one engine forward, in order (per encoder stage
    the first conv, stride 1 or 2, then the second; per decoder level the
    transpose, then the two convs), each with its FLOPs and bytes: bf16
    input read once (the stem's one channel), bf16 weights and bias, bf16
    output written once."""
    f = [int(v) for v in arch["features"]]
    S = _sizes(arch, in_shape)
    B, X, Y, Z = (int(v) for v in in_shape[:4])
    out: List[Dict] = []

    def conv(kind, s_in, s_out, cin, cout):
        out.append(dict(kind=kind, flops=2 * 27 * s_out * cin * cout,
                        bytes=s_in * cin * 2 + 27 * cin * cout * 2 + cout * 2 + s_out * cout * 2))

    s_prev, cin = B * X * Y * Z, int(arch["in_channels"])
    for i, c in enumerate(f):
        conv("down" if S[i] != s_prev else "same", s_prev, S[i], cin, c)
        conv("same", S[i], S[i], c, c)
        s_prev, cin = S[i], c
    for k in range(len(f) - 1):
        i = len(f) - 2 - k
        s_in, c_in, c_out = S[i + 1], f[i + 1], f[i]
        out.append(dict(kind="up2", flops=2 * s_in * c_in * 8 * c_out,
                        bytes=s_in * c_in * 2 + 8 * c_in * c_out * 2 + c_out * 2
                        + 8 * s_in * c_out * 2))
        conv("same", S[i], S[i], 2 * c_out, c_out)
        conv("same", S[i], S[i], c_out, c_out)
    return out


def norm_layers(arch: dict, in_shape: Sequence[int]) -> List[Dict]:
    """Each instance norm + LeakyReLU of one forward, in order, with the
    bytes that bound it: a read of the bf16 conv output, a write of the bf16
    activation and its f32 scale and shift."""
    f = [int(v) for v in arch["features"]]
    S = _sizes(arch, in_shape)
    out = []
    for i in list(range(len(f))) + [len(f) - 2 - k for k in range(len(f) - 1)]:
        for _ in range(2):
            out.append(dict(voxels=S[i], channels=f[i], bytes=2 * S[i] * f[i] * 2 + 2 * f[i] * 4))
    return out
