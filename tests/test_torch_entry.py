"""The port's driver entry points (``syconn_tpu_torch/tools/entry.py``)
against ``__graft_entry__.py``.

``entry()``: the port's ``fn`` with the JAX ``entry()``'s own params
(numpy leaves) against JAX's ``fn`` on a seeded (1, 32, 32, 16, 1) input,
under the dense tolerances of ``tests/test_conv_pallas.py:100-164``: the
max logit within a median relative 3e-2 (denominator floored at 0.05) and
argmax flips below 2e-2. The CPU ``fn`` is the plain ``UNet3D.forward``;
the engine on CPU tensors (the conv kernels' plain versions, the op order
of the card's route) is held to the same tolerances.

``dryrun_multichip(8)`` on a logical CPU mesh passes its five checks.
"""

import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _jax_entry(monkeypatch):
    """JAX's ``entry()``, its params traced on a (1, 32, 32, 16, 1) zeros
    input instead of (1, 128, 128, 64, 1): flax draws each parameter from the
    key folded with the module path, so the values do not depend on the
    spatial extent, and the trace costs a sixteenth."""
    sys.path.insert(0, ROOT)
    try:
        import __graft_entry__ as graft
    finally:
        sys.path.remove(ROOT)
    from syconn_tpu.models import io as jio

    init = jio.init_model_params
    monkeypatch.setattr(jio, "init_model_params",
                        lambda model, shape, seed=0: init(model, (1, 32, 32, 16, 1), seed))
    return graft.entry()


def _dense_tolerance(got_max, got_arg, ref_max, ref_arg):
    rel = np.abs(got_max - ref_max) / np.maximum(np.abs(ref_max), 0.05)
    assert np.median(rel) < 3e-2, float(np.median(rel))
    assert np.mean(got_arg != ref_arg) < 2e-2, float(np.mean(got_arg != ref_arg))


def _model():
    from syconn_tpu_torch.models.unet3d import UNet3D, unet_variants

    return UNet3D(**unet_variants("organelles"))


def test_entry_matches_the_jax_forward(monkeypatch):
    from syconn_tpu_torch.models.convert import params_from_flax
    from syconn_tpu_torch.models.unet_engine import unet_apply_full
    from syconn_tpu_torch.tools.entry import ENTRY_SHAPE, entry

    jfn, (jparams, jx) = _jax_entry(monkeypatch)
    fn, (params, x) = entry(device="cpu")
    assert tuple(x.shape) == tuple(jx.shape) == ENTRY_SHAPE and x.device.type == "cpu"
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(jparams)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    xs = np.random.default_rng(7).integers(0, 255, (1, 32, 32, 16, 1)).astype(np.float32)
    ref_arg, ref_max = (np.asarray(a) for a in jax.jit(jfn)(jparams, xs))
    arg, mx = fn(tree, xs)
    assert arg.shape == mx.shape == ref_arg.shape == (1, 32, 32, 16)
    _dense_tolerance(mx.numpy(), arg.numpy(), ref_max, ref_arg)
    again = fn(tree, torch.from_numpy(xs))  # the converted tree is kept
    assert torch.equal(again[0], arg) and torch.equal(again[1], mx)
    logits = unet_apply_full(_model(), params_from_flax(tree, "cpu"), torch.from_numpy(xs))
    emax = logits.max(dim=-1)
    _dense_tolerance(emax.values.numpy(), emax.indices.numpy(), ref_max, ref_arg)
    # the port's own seed-0 params run too
    arg0, mx0 = fn(params, xs)
    assert torch.isfinite(mx0).all() and arg0.shape == (1, 32, 32, 16)


def test_entry_refuses_without_a_card(monkeypatch):
    from syconn_tpu_torch.tools.entry import dryrun_multichip, entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (entry, lambda: dryrun_multichip(8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_dryrun_multichip_on_a_logical_cpu_mesh(capsys):
    from syconn_tpu_torch.tools.entry import dryrun_multichip, main

    res = main(["--device", "cpu"])
    assert res["mesh"] == {"data": 2, "sp": 2, "tp": 2} and res["tp_params"] > 0
    assert np.isfinite(res["loss"]) and res["pp_stages"] == 4 and np.isfinite(res["pp_loss"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK: mesh={'data': 2, 'sp': 2, 'tp': 2}, loss=")
    assert line.endswith(f"pp(4-stage) loss={res['pp_loss']:.4f}")
    # the other mesh shapes of the JAX version: (n/2, 2, 1) and (n, 1, 1)
    assert dryrun_multichip(2, device="cpu")["mesh"] == {"data": 1, "sp": 2, "tp": 1}
    one = dryrun_multichip(1, device="cpu")
    assert one["mesh"] == {"data": 1, "sp": 1, "tp": 1} and one["pp_loss"] is None
