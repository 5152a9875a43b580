"""The dense U-Net's 3x3x3 convolutions: hand-written CUDA kernels for Hopper
and their plain PyTorch versions.

Counterparts of the Pallas kernels in ``syconn_tpu/ops/conv3d_pallas.py``
(``conv3x3x3_ln_gelu`` :71, ``conv_transpose2x_bias`` :262,
``conv_down2x_bias`` :394). All three run the wgmma kernel of
``csrc/conv3d_wgmma.cu``; only a SAME conv whose head does not fit its shared
memory runs the mma.sync kernel of ``csrc/conv3d.cu``.

Layouts follow the JAX package: activations channels-last
``(B, X, Y, Z, C)`` bf16, conv kernels as ``(27, Cin, Cout)`` bf16 (the flax
DHWIO kernel with its three spatial axes flattened, tap = dx*9 + dy*3 + dz),
conv biases bf16, LayerNorm and head parameters f32.

The wgmma kernels read the weights as K-major stage images and the head as
three bf16 parts (:func:`pack_conv_weight`, :func:`pack_head`); the wrappers
keep the public layout and repack once per parameter tensor.

Each wrapper runs its plain version for CPU tensors and launches its kernel
for CUDA tensors (raising on what the kernel does not take); there is no
fallback from one to the other. ``LAUNCHES`` counts kernel launches, those of
the port's other kernels included (each wrapper adds to its own entry).
"""

from __future__ import annotations

import functools
import weakref
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "LAUNCHES", "reset_launch_counts",
    "conv3x3x3_ln_gelu", "conv_down2x_bias", "conv_transpose2x_bias",
    "conv3x3x3_ln_gelu_ref", "conv_down2x_bias_ref", "conv_transpose2x_bias_ref",
    "pack_conv_weight", "unpack_conv_weight", "split_head", "pack_head", "tile_plan",
]

LAUNCHES: Dict[str, int] = {
    "conv3x3x3_ln_gelu": 0,
    "conv_down2x_bias": 0,
    "conv_transpose2x_bias": 0,
    "detect_cs_columns": 0,  # ops/contacts_cuda.py
    "dense_head": 0,  # ops/head.py
}

_MODE_SAME, _MODE_DOWN, _MODE_UP = 0, 1, 2
_MODE_NAMES = {_MODE_SAME: "same", _MODE_DOWN: "down", _MODE_UP: "up"}
_EPI_BIAS, _EPI_LN_GELU = 0, 1
_COUTS = (32, 64, 128, 256)
_BF16 = torch.bfloat16


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain versions
def _conv_f32(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              pads=(1, 1, 1, 1, 1, 1)) -> torch.Tensor:
    """f32 conv of bf16-rounded operands (exact bf16 products, f32 sums);
    x (B, X, Y, Z, Cin), w (27, Cin, Cout) -> (B, X', Y', Z', Cout) f32."""
    cin, cout = w.shape[1], w.shape[2]
    xf = x.to(_BF16).float().permute(0, 4, 1, 2, 3)
    wf = w.to(_BF16).float().reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2)
    y = F.conv3d(F.pad(xf, pads), wf, stride=stride)
    return y.permute(0, 2, 3, 4, 1)


def _bias_bf16(acc: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Round the f32 accumulator to bf16, then add the bias in bf16."""
    return acc.to(_BF16) + b.to(_BF16)


def _gelu_tanh(y: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu (approximate=True), evaluated in y's dtype
    return y * (0.5 * (1.0 + torch.tanh(0.7978845608028654 * (y + 0.044715 * (y * y * y)))))


def _ln_gelu(hb: torch.Tensor, g: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """LayerNorm (f32, var = E[x^2] - mu^2, eps 1e-6) + tanh-GELU in f32."""
    h = hb.float()
    mu = h.mean(-1, keepdim=True)
    var = (h * h).mean(-1, keepdim=True) - mu * mu
    y = (h - mu) * torch.rsqrt(var + 1e-6) * g.float() + beta.float()
    return _gelu_tanh(y)


def conv3x3x3_ln_gelu_ref(x, w, b, ln_scale=None, ln_bias=None, epilogue="ln_gelu",
                          head_w=None, head_b=None):
    """Plain version of :func:`conv3x3x3_ln_gelu` (same arguments)."""
    hb = _bias_bf16(_conv_f32(x, w), b)
    if epilogue == "bias":
        return hb
    y = _ln_gelu(hb, ln_scale, ln_bias).to(_BF16)
    if head_w is None:
        return y
    return y.float() @ head_w.float() + head_b.float()


def conv_down2x_bias_ref(x, w, b):
    """Plain version of :func:`conv_down2x_bias`: pad high by 1, stride 2."""
    return _bias_bf16(_conv_f32(x, w, stride=2, pads=(0, 1, 0, 1, 0, 1)), b)


def zero_stuff(x: torch.Tensor, stride=(2, 2, 2)) -> torch.Tensor:
    """Place x[u] at u*s + 1 of an s-times larger zero grid per axis: the
    flax SAME ``ConvTranspose`` of x is then the SAME 3x3x3 conv (unflipped
    kernel) of this grid."""
    b, X, Y, Z, c = x.shape
    sx, sy, sz = (int(s) for s in stride)
    out = x.new_zeros((b, X * sx, Y * sy, Z * sz, c), dtype=_BF16)
    ox, oy, oz = (1 if s > 1 else 0 for s in (sx, sy, sz))
    out[:, ox::sx, oy::sy, oz::sz] = x.to(_BF16)
    return out


def conv_transpose2x_bias_ref(x, w, b):
    """Plain version of :func:`conv_transpose2x_bias`: the zero-stuffed
    formulation (``unet_engine.py`` UP_PHASES=0 in the JAX package)."""
    return _bias_bf16(_conv_f32(zero_stuff(x), w), b)


# --------------------------------------------- operand images of the kernels
_KC = 32            # input channels per halo slice and weight stage
_HEAD_CHUNK = 32    # logits per head product; Nh is padded to a multiple
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on the H100


def pack_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """(27, Cin, Cout) -> (27, ceil(Cin / 32), 4, Cout, 8): per tap and
    32-channel slice one contiguous K-major stage image [8-channel group]
    [Cout][8 channels], Cin zero-padded to a multiple of 32."""
    taps, cin, cout = w.shape
    nk = -(-cin // _KC)
    wp = w.new_zeros((taps, nk * _KC, cout))
    wp[:, :cin] = w
    return wp.reshape(taps, nk, _KC // 8, 8, cout).permute(0, 1, 2, 4, 3).contiguous()


def unpack_conv_weight(wp: torch.Tensor, cin: int) -> torch.Tensor:
    """Inverse of :func:`pack_conv_weight`."""
    taps, nk, _, cout, _ = wp.shape
    return wp.permute(0, 1, 2, 4, 3).reshape(taps, nk * _KC, cout)[:, :cin].contiguous()


def split_head(head_w: torch.Tensor) -> torch.Tensor:
    """f32 (Cout, Nh) -> bf16 (3, Cout, Nh) with hi + mid + lo == head_w to
    f32's resolution: each part is the bf16 rounding of what the earlier
    parts left (3 x 8 mantissa bits cover f32's 24)."""
    rest = head_w.float()
    parts = []
    for _ in range(3):
        part = rest.to(_BF16)
        parts.append(part)
        rest = rest - part.float()
    return torch.stack(parts)


def pack_head(head_w: torch.Tensor) -> torch.Tensor:
    """f32 (Cout, Nh) -> bf16 (3, Cout / 8, Nhp, 8): the three parts of
    :func:`split_head`, K-major, Nh zero-padded to a multiple of 32."""
    cout, nh = head_w.shape
    nhp = -(-nh // _HEAD_CHUNK) * _HEAD_CHUNK
    parts = head_w.new_zeros((3, cout, nhp), dtype=_BF16)
    parts[:, :, :nh] = split_head(head_w)
    return parts.reshape(3, cout // 8, 8, nhp).permute(0, 1, 3, 2).contiguous()


# the stride-2 conv's 64-row tiles per consumer warpgroup by Cout (tiles_of()
# of csrc/conv3d_wgmma.cu)
DOWN_TILES = {32: 4, 64: 4, 128: 2, 256: 1}


def tile_plan(mode: str, cin: int, cout: int, nh: int = 0) -> Optional[Dict[str, int]]:
    """The wgmma kernel's tile plan for one shape, mirroring ``plan_of`` and
    ``make_layout`` of ``csrc/conv3d_wgmma.cu``: brick, halo buffers, ring
    depth, steps of the main loop and shared-memory bytes; None
    when the kernel does not take the shape (a head too wide for its shared
    memory)."""
    if mode not in ("same", "down", "up") or cout not in _COUTS or cin <= 0 or cin % 8:
        raise ValueError(f"no tile plan for mode={mode!r} Cin={cin} Cout={cout}")
    if nh and mode != "same":
        raise ValueError("only the SAME conv fuses a head")
    if mode == "same":
        mt = {256: 1, 128: 2}.get(cout, 4)      # 64-row tiles per consumer warpgroup
    elif mode == "down":
        mt = DOWN_TILES[cout]
    else:
        mt = 1 if cout >= 128 else 2
    bx = 2 * mt
    e = 2 if mode == "same" else 1              # the stride-2 conv: one input phase
    hp = (bx + e) * (8 + e) * (8 + e)           # halo positions
    # plane stride, 16-byte units: 2 mod 8 against the loaders' bank conflicts,
    # or (the stride-2 conv's TMA units) 128-byte aligned
    ps = -(-hp // 8) * 8 if mode == "down" else hp + (10 - hp % 8) % 8
    halo_bytes = 4 * ps * 16
    stage_bytes = _KC * cout * 2
    nk = -(-cin // _KC)
    nhp = -(-nh // _HEAD_CHUNK) * _HEAD_CHUNK
    # per consumer warp 16 staged output rows (bf16, or 32 f32 logits), and with a
    # head the three bf16 parts of its weight
    rows = 16 * (cout * 2 + 16)
    if nh:
        rows = max(rows, 16 * (_HEAD_CHUNK + 4) * 4)
    tail = 8 * rows + 3 * cout * nhp * 2

    def total(halo_bufs, stages):
        return (640 + -(-cout * 10 // 128) * 128 + halo_bufs * halo_bytes
                + stages * stage_bytes + tail)

    halo_bufs = 2       # slices stream; the transpose keeps all resident when they fit
    if mode == "up" and 2 < nk <= 16 and total(nk, 4) <= SMEM_LIMIT:
        halo_bufs = nk
    if mode == "down":
        halo_bufs = 4   # eight input-phase units a slice stream through four
    stages = min(16, (SMEM_LIMIT - total(halo_bufs, 0)) // stage_bytes)
    if stages < 2:
        return None
    return dict(brick=(bx, 8, 8), rows=bx * 64, halo_bufs=halo_bufs, stages=stages,
                halo_bytes=halo_bytes, stage_bytes=stage_bytes, steps=27 * nk, nhp=nhp,
                smem_bytes=total(halo_bufs, stages))


@functools.lru_cache(maxsize=None)
def _takes_wgmma(mode: str, cin: int, cout: int, nh: int) -> bool:
    return tile_plan(mode, cin, cout, nh) is not None


# id(parameter) -> (weak reference, version, packed image); an entry dies with
# its tensor and is rebuilt when the tensor was written in place
_PACKED: Dict[Tuple[int, str], tuple] = {}


def _packed(t: torch.Tensor, kind: str, pack) -> torch.Tensor:
    key = (id(t), kind)
    hit = _PACKED.get(key)
    if hit is not None and hit[0]() is t and hit[1] == t._version:
        return hit[2]
    image = pack(t)
    _PACKED[key] = (weakref.ref(t, lambda _, k=key: _PACKED.pop(k, None)), t._version, image)
    return image


# ------------------------------------------------------------------ kernels
def _check(t: Optional[torch.Tensor], name: str, dtype, shape, device):
    if t is None:
        raise ValueError(f"{name} is required")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(mode, epi, x, w, b, g, beta, hw, hb, out, nh):
    from .build import library

    B, X, Y, Z, cin = x.shape
    cout = w.shape[2]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    wgmma = _takes_wgmma(_MODE_NAMES[mode], cin, cout, nh)
    with torch.cuda.device(x.device):
        if wgmma:
            lib = library("conv3d_wgmma")
            wp = _packed(w, "conv", pack_conv_weight)
            hp = None if hw is None else _packed(hw, "head", pack_head)
            rc = lib.conv3d_wgmma_launch(
                mode, epi, _ptr(x), _ptr(wp), _ptr(b), _ptr(g), _ptr(beta), _ptr(hp),
                _ptr(hb), _ptr(out), B, X, Y, Z, cin, cout, nh, stream)
            err = lib.conv3d_wgmma_error_string
        else:  # the tile plan sends only a SAME conv with a wide head here
            lib = library("conv3d")
            rc = lib.conv3d_launch(
                mode, epi, _ptr(x), _ptr(w), _ptr(b), _ptr(g), _ptr(beta), _ptr(hw),
                _ptr(hb), _ptr(out), B, X, Y, Z, cin, cout, nh, stream)
            err = lib.conv3d_error_string
    if rc != 0:
        raise RuntimeError(f"conv3d kernel launch failed: {err(rc).decode()}")


def _check_conv(x, w, b):
    if x.dim() != 5:
        raise ValueError(f"x must be (B, X, Y, Z, C), got {tuple(x.shape)}")
    cin = x.shape[-1]
    if w.dim() != 3 or w.shape[0] != 27 or w.shape[1] != cin:
        raise ValueError(f"w must be (27, {cin}, Cout), got {tuple(w.shape)}")
    cout = w.shape[2]
    if cin % 8 or cout not in _COUTS:
        raise ValueError(f"the kernel takes Cin % 8 == 0 and Cout in {_COUTS}, "
                         f"got Cin={cin} Cout={cout}")
    _check(x, "x", _BF16, x.shape, x.device)
    _check(w, "w", _BF16, w.shape, x.device)
    _check(b, "b", _BF16, (cout,), x.device)
    return cout


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


def conv3x3x3_ln_gelu(x, w, b, ln_scale=None, ln_bias=None, epilogue="ln_gelu",
                      head_w=None, head_b=None):
    """y = GELU(LayerNorm(Conv3D_same_3x3x3(x, w) + b)).

    Args:
        x: (B, X, Y, Z, Cin) bf16.
        w: (27, Cin, Cout) bf16; b: (Cout,) bf16.
        ln_scale, ln_bias: (Cout,) f32; unused for ``epilogue="bias"``.
        epilogue: "ln_gelu" (ConvBlock unit) or "bias" (linear conv).
        head_w, head_b: optional fused 1x1x1 head, (Cout, Nh) and (Nh,) f32,
            applied in f32 to the bf16-rounded activation.
    Returns:
        (B, X, Y, Z, Cout) bf16, or (B, X, Y, Z, Nh) f32 with a head.
    """
    if epilogue not in ("ln_gelu", "bias"):
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if head_w is not None and epilogue != "ln_gelu":
        raise ValueError("the head fuses onto the ln_gelu epilogue")
    if _on_cpu(x):
        return conv3x3x3_ln_gelu_ref(x, w, b, ln_scale, ln_bias, epilogue, head_w, head_b)
    cout = _check_conv(x, w, b)
    B, X, Y, Z, _ = x.shape
    nh = 0
    epi = _EPI_BIAS
    if epilogue == "ln_gelu":
        epi = _EPI_LN_GELU
        _check(ln_scale, "ln_scale", torch.float32, (cout,), x.device)
        _check(ln_bias, "ln_bias", torch.float32, (cout,), x.device)
    else:
        ln_scale = ln_bias = None
    if head_w is not None:
        nh = int(head_w.shape[-1])
        _check(head_w, "head_w", torch.float32, (cout, nh), x.device)
        _check(head_b, "head_b", torch.float32, (nh,), x.device)
        out = torch.empty((B, X, Y, Z, nh), dtype=torch.float32, device=x.device)
    else:
        head_b = None
        out = torch.empty((B, X, Y, Z, cout), dtype=_BF16, device=x.device)
    _launch(_MODE_SAME, epi, x, w, b, ln_scale, ln_bias, head_w, head_b, out, nh)
    LAUNCHES["conv3x3x3_ln_gelu"] += 1
    return out


def conv_down2x_bias(x, w, b):
    """flax ``nn.Conv`` (SAME, k=3, strides=2) + bias for even extents:
    out[o] = sum_d W_d x[2o + d] (pad low 0, high 1).

    x: (B, X, Y, Z, Cin) bf16; w: (27, Cin, Cout) bf16; b: (Cout,) bf16.
    Returns (B, X/2, Y/2, Z/2, Cout) bf16."""
    if any(int(s) % 2 for s in x.shape[1:4]):
        raise ValueError(f"conv_down2x_bias needs even extents, got {tuple(x.shape)}")
    if _on_cpu(x):
        return conv_down2x_bias_ref(x, w, b)
    cout = _check_conv(x, w, b)
    B, X, Y, Z, _ = x.shape
    out = torch.empty((B, X // 2, Y // 2, Z // 2, cout), dtype=_BF16, device=x.device)
    _launch(_MODE_DOWN, _EPI_BIAS, x, w, b, None, None, None, None, out, 0)
    LAUNCHES["conv_down2x_bias"] += 1
    return out


def conv_transpose2x_bias(x, w, b):
    """flax ``nn.ConvTranspose`` (SAME, k=3, s=2) + bias, computed as the 8
    sub-pixel output phases (each reads only its own taps; one block of the
    kernel computes all eight for its brick).

    x: (B, X, Y, Z, Cin) bf16; w: (27, Cin, Cout) bf16; b: (Cout,) bf16.
    Returns (B, 2X, 2Y, 2Z, Cout) bf16."""
    if _on_cpu(x):
        return conv_transpose2x_bias_ref(x, w, b)
    cout = _check_conv(x, w, b)
    B, X, Y, Z, _ = x.shape
    out = torch.empty((B, 2 * X, 2 * Y, 2 * Z, cout), dtype=_BF16, device=x.device)
    _launch(_MODE_UP, _EPI_BIAS, x, w, b, None, None, None, None, out, 0)
    LAUNCHES["conv_transpose2x_bias"] += 1
    return out
