"""The dense step's head: crop, class softmax and quantise (or threshold and
bit-pack) of the U-Net engine's packed f32 logits, as one hand-written CUDA
kernel (``csrc/head.cu``) and its plain PyTorch version.

The JAX package's head is plain ``jnp`` inside the predictor's jitted
forward (``syconn_tpu/inference/dense.py``, ``fwd``); there is no Pallas
kernel to port. On the card the plain version is five passes over the
logits, so the kernel reads each cropped logit once and writes the uint8
result once (PERF.md §6).

:func:`dense_head` runs :func:`dense_head_ref` for CPU tensors and launches
the kernel for CUDA tensors (raising on what the kernel does not take); there
is no fallback from one to the other. Each launch adds to
``ops.conv3d.LAUNCHES["dense_head"]`` and sets ``fused_tiles`` (the tiles it
took) on this thread's innermost open span (``engine.head`` in the dense
step).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..utils import tracing
from .conv3d import LAUNCHES

__all__ = ["dense_head", "dense_head_ref", "head_plan"]

_MODES = {"probs": 0, "masks": 1}
# logits of one block's piece of a z-run held in shared memory
MAX_PIECE_BYTES = 32 * 1024


def dense_head_ref(lg: torch.Tensor, hp, tsp, n_classes: int, pvox: int, mode: str = "probs",
                   thr: Optional[torch.Tensor] = None,
                   bit_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`dense_head` (same arguments), on any device."""
    lg = lg[:, hp[0]:hp[0] + tsp[0], hp[1]:hp[1] + tsp[1], hp[2]:hp[2] + tsp[2], :]
    b, sx, sy, sz, _ = lg.shape
    C = n_classes
    probs = torch.softmax(lg.reshape(b, sx, sy, sz, C, pvox), dim=-2)
    if mode == "probs":
        out = torch.round(probs * 255.0).to(torch.uint8)
        return out.reshape(b, sx, sy, sz, C * pvox)
    fg = (probs >= thr).reshape(b, sx, sy, sz, C * pvox // 8, 8)
    return (fg.to(torch.uint8) * bit_weights).sum(-1, dtype=torch.uint8)


def head_plan(n_classes: int, pvox: int, sz: int) -> Optional[Dict[str, int]]:
    """The kernel's block plan, as ``csrc/head.cu`` takes it: ``P`` positions
    of a z-run a block and ``S`` floats a position in shared memory (``S =
    pvox (mod 32)`` where pvox < 32 and pvox % 4 == 0, so one warp's
    positions lie on distinct banks); None when one position's logits do not
    fit."""
    n = n_classes * pvox
    s = n + ((pvox - n) % 32 if pvox < 32 and pvox % 4 == 0 else 0)
    p = min(sz, MAX_PIECE_BYTES // (4 * s))
    return dict(P=p, S=s) if p >= 1 else None


def _check_args(lg, hp, tsp, n_classes, pvox, mode, thr, bit_weights):
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    n = n_classes * pvox
    if lg.dim() != 5 or lg.shape[-1] != n:
        raise ValueError(f"expected logits (B, SX, SY, SZ, {n_classes} * {pvox}), got "
                         f"{tuple(lg.shape)}")
    if n % (8 if mode == "masks" else 4):
        raise ValueError("n_classes * patch voxels must be a multiple of 4 (probs) or of 8 "
                         f"(masks), got {n_classes} x {pvox} in {mode} mode")
    if len(hp) != 3 or len(tsp) != 3 or min(hp) < 0 or min(tsp) < 1 or any(
            h + t > s for h, t, s in zip(hp, tsp, lg.shape[1:4])):
        raise ValueError(f"crop start {hp}, extent {tsp} outside logits {tuple(lg.shape)}")
    if mode == "masks" and (thr is None or bit_weights is None):
        raise ValueError("masks mode needs thr and bit_weights")


def dense_head(lg: torch.Tensor, hp: Sequence[int], tsp: Sequence[int], n_classes: int,
               pvox: int, mode: str = "probs", thr: Optional[torch.Tensor] = None,
               bit_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Crop the haloed logits, softmax over the classes, quantise or pack.

    Args:
        lg: (B, SX, SY, SZ, C * pvox) f32 packed logits, channel
            ``c * pvox + v`` = class c at patch voxel v (as
            ``models.unet_engine.unet_apply_packed`` returns them); C * pvox
            a multiple of 4 (probs) or 8 (masks).
        hp, tsp: crop start and extent in patched positions.
        n_classes, pvox: C and the patch's voxels.
        mode: ``"probs"`` or ``"masks"``.
        thr: (C, 1) f32 per-class thresholds on ``p`` (masks mode).
        bit_weights: (8,) uint8 ``[1, 2, ..., 128]`` (masks mode); the
            kernel packs in that order.
    Returns:
        contiguous uint8 (B, sx, sy, sz, C * pvox) ``round(p * 255)``
        (probs), or (B, sx, sy, sz, C * pvox / 8) whose byte j, bit k is
        ``p >= thr`` of channel 8j + k (masks).
    """
    hp, tsp = tuple(int(h) for h in hp), tuple(int(t) for t in tsp)
    n_classes, pvox = int(n_classes), int(pvox)
    _check_args(lg, hp, tsp, n_classes, pvox, mode, thr, bit_weights)
    if lg.device.type == "cpu":
        return dense_head_ref(lg, hp, tsp, n_classes, pvox, mode, thr, bit_weights)
    if lg.device.type != "cuda":
        raise ValueError(f"unsupported device {lg.device}")
    if lg.dtype != torch.float32 or not lg.is_contiguous() or lg.data_ptr() % 16:
        raise ValueError("the head kernel takes contiguous, 16-byte aligned f32 logits")
    if mode == "masks":
        if thr.dtype != torch.float32 or thr.device != lg.device or thr.numel() != n_classes \
                or not thr.is_contiguous():
            raise ValueError(f"thr must be {n_classes} contiguous f32 values on {lg.device}")
    plan = head_plan(n_classes, pvox, tsp[2])
    if plan is None:
        raise ValueError(f"{n_classes} x {pvox} logits a position do not fit the kernel's "
                         "shared memory")
    from .build import library

    lib = library("head")
    B, SX, SY, SZ, n = lg.shape
    ob = n if mode == "probs" else n // 8
    out = torch.empty((B, *tsp, ob), dtype=torch.uint8, device=lg.device)
    stream = torch.cuda.current_stream(lg.device).cuda_stream
    with torch.cuda.device(lg.device):
        rc = lib.dense_head_launch(
            lg.data_ptr(), thr.data_ptr() if mode == "masks" else None, out.data_ptr(), B, SX,
            SY, SZ, n_classes, pvox, *hp, *tsp, _MODES[mode], plan["P"], plan["S"], stream)
    if rc != 0:
        raise RuntimeError(f"head kernel launch failed: {lib.dense_head_error_string(rc).decode()}")
    LAUNCHES["dense_head"] += 1
    tracing.annotate(fused_tiles=B)
    return out
