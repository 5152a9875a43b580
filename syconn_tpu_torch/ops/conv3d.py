"""The dense U-Net's 3x3x3 convolutions: hand-written CUDA kernels for Hopper
and their plain PyTorch versions.

Counterparts of the Pallas kernels in ``syconn_tpu/ops/conv3d_pallas.py``
(``conv3x3x3_ln_gelu`` :70, ``conv_transpose2x_bias`` :261,
``conv_down2x_bias`` :393); the kernels live in ``csrc/conv3d.cu``.

Layouts follow the JAX package: activations channels-last
``(B, X, Y, Z, C)`` bf16, conv kernels as ``(27, Cin, Cout)`` bf16 (the flax
DHWIO kernel with its three spatial axes flattened, tap = dx*9 + dy*3 + dz),
conv biases bf16, LayerNorm and head parameters f32.

Each wrapper runs its plain version for CPU tensors and launches its kernel
for CUDA tensors (raising on what the kernel does not take); there is no
fallback from one to the other. ``LAUNCHES`` counts kernel launches, those of
the port's other kernels included (each wrapper adds to its own entry).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

__all__ = [
    "LAUNCHES", "reset_launch_counts",
    "conv3x3x3_ln_gelu", "conv_down2x_bias", "conv_transpose2x_bias",
    "conv3x3x3_ln_gelu_ref", "conv_down2x_bias_ref", "conv_transpose2x_bias_ref",
]

LAUNCHES: Dict[str, int] = {
    "conv3x3x3_ln_gelu": 0,
    "conv_down2x_bias": 0,
    "conv_transpose2x_bias": 0,
    "detect_cs_columns": 0,  # ops/contacts_cuda.py
}

_MODE_SAME, _MODE_DOWN, _MODE_UP = 0, 1, 2
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
    lib = library("conv3d")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.conv3d_launch(
            mode, epi, _ptr(x), _ptr(w), _ptr(b), _ptr(g), _ptr(beta), _ptr(hw),
            _ptr(hb), _ptr(out), B, X, Y, Z, cin, cout, nh, stream)
    if rc != 0:
        raise RuntimeError(
            f"conv3d kernel launch failed: {lib.conv3d_error_string(rc).decode()}")


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
    sub-pixel output phases (each reads only its own taps).

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
