"""The port's conv ops (ops/conv3d.py) against the Pallas kernels of
syconn_tpu/ops/conv3d_pallas.py, run in interpret mode as
tests/test_conv_pallas.py runs them.

Tolerance (bf16 resolution; the two sides accumulate the same exact bf16
products in f32 in a different order, then round to bf16): median relative
error < 2e-2 and fewer than 2% of elements off by more than 10%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syconn_tpu.ops import conv3d_pallas as P
from syconn_tpu_torch.models.convert import kernel_taps
from syconn_tpu_torch.ops import conv3d as C


def _close(got, ref, floor=1e-2):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), floor)
    assert np.median(rel) < 2e-2, float(np.median(rel))
    assert np.mean(rel > 0.1) < 2e-2, float(np.mean(rel > 0.1))


def _inputs(shape, cout, seed, nh=0):
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    x = (rng.normal(size=shape) * 2.0).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # bf16-exact
    w = (rng.normal(size=(3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=cout)).astype(np.float32)
    beta = (0.1 * rng.normal(size=cout)).astype(np.float32)
    hw = (rng.normal(size=(cout, nh)) / np.sqrt(max(cout, 1))).astype(np.float32)
    hb = (0.1 * rng.normal(size=nh)).astype(np.float32)
    return x, w, b, g, beta, hw, hb


def _t(x):
    return torch.from_numpy(np.array(x))  # writable copy


def _port_args(x, w, b):
    return (_t(x).to(torch.bfloat16), kernel_taps(w), _t(b).to(torch.bfloat16))


@pytest.mark.parametrize("shape,cout", [
    ((1, 16, 16, 16, 32), 64),   # stem widths
    ((2, 8, 8, 24, 64), 64),     # z not a multiple of the brick
    ((1, 14, 14, 14, 48), 64),   # odd block divisors
])
def test_conv3x3x3_ln_gelu_matches_pallas(shape, cout):
    x, w, b, g, beta, _, _ = _inputs(shape, cout, 0)
    ref = P.conv3x3x3_ln_gelu(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
                              jnp.asarray(g), jnp.asarray(beta), interpret=True)
    got = C.conv3x3x3_ln_gelu(*_port_args(x, w, b), _t(g), _t(beta))
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), ref)


def test_conv3x3x3_fused_head_matches_pallas():
    x, w, b, g, beta, hw, hb = _inputs((1, 8, 8, 8, 32), 64, 1, nh=96)
    ref = P.conv3x3x3_ln_gelu(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
                              jnp.asarray(g), jnp.asarray(beta), interpret=True,
                              head_w=jnp.asarray(hw), head_b=jnp.asarray(hb))
    got = C.conv3x3x3_ln_gelu(*_port_args(x, w, b), _t(g), _t(beta), head_w=_t(hw), head_b=_t(hb))
    assert got.dtype == torch.float32 and got.shape[-1] == 96
    _close(got.numpy(), ref)


def test_conv3x3x3_bias_epilogue_matches_pallas():
    x, w, b, g, beta, _, _ = _inputs((1, 8, 8, 16, 64), 32, 2)
    ref = P.conv3x3x3_ln_gelu(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
                              jnp.asarray(g), jnp.asarray(beta), interpret=True, epilogue="bias")
    got = C.conv3x3x3_ln_gelu(*_port_args(x, w, b), epilogue="bias")
    _close(got.float().numpy(), ref)


@pytest.mark.parametrize("shape,cout", [
    ((1, 16, 16, 16, 32), 64),
    ((1, 8, 8, 24, 48), 64),
])
def test_conv_down2x_matches_pallas(shape, cout):
    x, w, b, *_ = _inputs(shape, cout, 5)
    ref = P.conv_down2x_bias(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
                             interpret=True)
    got = C.conv_down2x_bias(*_port_args(x, w, b))
    _close(got.float().numpy(), ref)


@pytest.mark.parametrize("shape,cout", [
    ((1, 8, 8, 16, 24), 16),
    ((1, 4, 6, 8, 64), 32),
])
def test_conv_transpose2x_matches_pallas(shape, cout):
    x, w, b, *_ = _inputs(shape, cout, 3)
    ref = P.conv_transpose2x_bias(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
                                  interpret=True)
    got = C.conv_transpose2x_bias(*_port_args(x, w, b))
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], 2 * shape[3], cout)
    _close(got.float().numpy(), ref)


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain versions: no launch counted."""
    x, w, b, g, beta, _, _ = _inputs((1, 4, 4, 4, 32), 32, 4)
    C.reset_launch_counts()
    C.conv3x3x3_ln_gelu(*_port_args(x, w, b), _t(g), _t(beta))
    C.conv_down2x_bias(*_port_args(x, w, b))
    C.conv_transpose2x_bias(*_port_args(x, w, b))
    assert all(v == 0 for v in C.LAUNCHES.values())
    with pytest.raises(ValueError, match="even"):
        C.conv_down2x_bias(*_port_args(x[:, :3], w, b))
    with pytest.raises(ValueError, match="epilogue"):
        C.conv3x3x3_ln_gelu(*_port_args(x, w, b), epilogue="relu")

