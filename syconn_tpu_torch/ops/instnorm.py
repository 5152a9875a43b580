"""Instance normalisation + LeakyReLU of nnU-Net's conv blocks: a hand-written
CUDA kernel pair (``csrc/instnorm.cu``) and its plain PyTorch version.

``InstanceNorm3d(affine=True)`` normalises each (sample, channel) over the
whole spatial extent, so it cannot ride in a conv kernel's per-row epilogue
as the U-Net's LayerNorm does: it is a reduction over the tile between two
convs. The kernel reads the bf16 conv output twice (statistics, then the
normalisation) and writes the bf16 activation once.

Layout as the conv kernels': channels-last ``(B, X, Y, Z, C)`` bf16, the
affine parameters f32. Statistics in f32: mean and biased variance by
Welford's update and Chan's pairwise combination (``csrc/instnorm.cu``); the
plain version takes them in f32 by two passes.

:func:`instance_norm_lrelu` runs :func:`instance_norm_lrelu_ref` for CPU
tensors and launches the kernels for CUDA tensors (raising on what they do
not take); there is no fallback from one to the other. Each call adds its two
kernel launches to ``ops.conv3d.LAUNCHES["instance_norm"]``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .conv3d import LAUNCHES

__all__ = ["instance_norm_lrelu", "instance_norm_lrelu_ref"]

# (device, stream) -> uint32 ticket counters the stats kernel leaves zeroed;
# one set a stream, so that calls on two streams of a device never share one
_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def instance_norm_lrelu_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                            eps: float = 1e-5, slope: float = 0.01) -> torch.Tensor:
    """Plain version of :func:`instance_norm_lrelu` (same arguments), on any
    device: the statistics of the f32 values in two passes, then
    ``x * scale + shift`` with ``scale = gamma / sqrt(var + eps)`` and
    ``shift = beta - mean * scale``, LeakyReLU, bf16."""
    xf = x.float()
    dims = tuple(range(1, x.dim() - 1))
    mean = xf.mean(dims, keepdim=True)
    var = (xf - mean).square().mean(dims, keepdim=True)
    scale = gamma.float() / torch.sqrt(var + eps)
    shift = beta.float() - mean * scale
    y = xf * scale + shift
    return torch.where(y < 0, y * slope, y).to(torch.bfloat16)


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < n:
        t = _TICKETS[device, stream] = torch.zeros(max(n, 16), dtype=torch.int32, device=device)
    return t


def instance_norm_lrelu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        eps: float = 1e-5, slope: float = 0.01) -> torch.Tensor:
    """y = LeakyReLU(InstanceNorm(x) * gamma + beta), statistics per (sample,
    channel) over every voxel.

    Args:
        x: (B, X, Y, Z, C) bf16, C a multiple of 8 (at most 2048).
        gamma, beta: (C,) f32.
        eps: added to the biased variance; slope: LeakyReLU's for y < 0.
    Returns:
        (B, X, Y, Z, C) bf16.
    """
    if x.dim() != 5:
        raise ValueError(f"x must be (B, X, Y, Z, C), got {tuple(x.shape)}")
    C = int(x.shape[-1])
    for name, t in (("gamma", gamma), ("beta", beta)):
        if tuple(t.shape) != (C,):
            raise ValueError(f"{name} must be ({C},), got {tuple(t.shape)}")
    if x.device.type == "cpu":
        return instance_norm_lrelu_ref(x, gamma, beta, eps, slope)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the kernel takes contiguous, 16-byte aligned bf16 activations")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 on {x.device}")
    from .build import library

    lib = library("instnorm")
    B = int(x.shape[0])
    S = int(x.shape[1] * x.shape[2] * x.shape[3])
    n_ws = lib.instnorm_workspace(B, S, C)
    if n_ws == 0:
        raise ValueError(f"the kernel does not take B={B}, {S} voxels, C={C}")
    ws = torch.empty(n_ws, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tickets = _tickets(x.device, stream, B)
    with torch.cuda.device(x.device):
        rc = lib.instnorm_launch(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
                                 ws.data_ptr(), tickets.data_ptr(), B, S, C, float(eps),
                                 float(slope), stream)
    if rc != 0:
        # blocks that took a ticket before the failure would leave every later
        # call without a last block to write the statistics
        tickets.zero_()
        raise RuntimeError(f"instance norm launch failed: {lib.instnorm_error_string(rc).decode()}")
    LAUNCHES["instance_norm"] += 2
    return out
