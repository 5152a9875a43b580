"""The port's point nets (``syconn_tpu_torch/models/pointnet.py``) against
the JAX package's flax modules on the CPU, on the same parameters and
inputs:

* all five packaged point nets (celltype, compartments, glia, spines,
  triplet embeddings) through ``models.io.load_model`` at their own
  ``meta.npoints``, on contexts of ``extract_contexts`` that pad with
  repeated points: the kNN indices equal ``jax.lax.top_k`` exactly, the
  logits agree with flax ``apply`` within the dense budgets of ROADMAP.md
  (median relative error < 3e-2; argmax flips < 3e-3 on trained weights),
  both eager and jitted, and the embedding head is unit-norm;
* randomly initialised nets of every form (class net with global scalars
  and an embedding head, segmentation net with two kNN stages) converted
  with ``module_state_from_flax``: argmax flips < 2e-2;
* ``flax_gelu`` equals ``nn.gelu`` on bf16 exactly, and a missing model
  raises ``FileNotFoundError``.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

PACKAGED = ["celltype_pts", "compartment_pts", "glia_pts", "spiness", "tnet_pts"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _contexts(npoints, n_ctx, n_global=0, seed=0):
    """Contexts over a grid-snapped cloud (exact distance ties) with fewer
    points per context than ``npoints`` in part (padded duplicates)."""
    from syconn_tpu_torch.inference.points import extract_contexts

    rng = np.random.default_rng(seed)
    coords = (rng.integers(0, 30, (1500, 3)) * np.array([10, 10, 20])).astype(np.float32)
    types = rng.integers(0, 4, len(coords)).astype(np.int32)
    ctx, _ = extract_contexts(coords, types, ctx_size_nm=2400, npoints=npoints,
                              n_contexts=n_ctx, rng=np.random.default_rng(seed + 1))
    if n_global:
        s = rng.normal(size=(n_ctx, 1, n_global)).astype(np.float32)
        ctx = np.concatenate([ctx, np.broadcast_to(s, (n_ctx, npoints, n_global))], -1)
    return np.ascontiguousarray(ctx)


def _logits(out):
    return np.asarray(out["logits"] if isinstance(out, dict) else out, np.float32)


def _budget(got, ref, max_flips):
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-2)
    flips = float(np.mean(got.argmax(-1) != ref.argmax(-1)))
    assert np.all(np.isfinite(got))
    assert float(np.median(rel)) < 3e-2, float(np.median(rel))
    assert flips < max_flips, flips
    return float(np.median(rel)), flips


def _jax_knn(xyz, k):
    d2 = jnp.sum((xyz[:, :, None, :] - xyz[:, None, :, :]) ** 2, axis=-1)
    return np.asarray(jax.lax.top_k(-d2, k)[1])


@pytest.mark.parametrize("name", PACKAGED)
def test_packaged_point_nets_match_flax(name):
    from syconn_tpu.models.io import load_model as jload
    from syconn_tpu_torch.models.io import load_model, packaged_model_path
    from syconn_tpu_torch.models.pointnet import knn_indices

    path = packaged_model_path(name)
    with open(os.path.join(path, "arch.json")) as f:
        arch = json.load(f)
    npoints = int(arch["meta"]["npoints"])
    jm, jp = jload(path)
    tm, _ = load_model(path)
    n_global = int(arch["kwargs"].get("n_global", 0))
    ctx = _contexts(npoints, 2, n_global)
    # the contexts hold padded duplicates, so distance ties are exact
    assert any(len(np.unique(c[:, :3], axis=0)) < npoints for c in ctx)

    xyz = ctx[..., :3]
    k = int(arch["kwargs"]["k"])
    ref_idx = _jax_knn(jnp.asarray(xyz), k)
    got_idx = knn_indices(torch.from_numpy(np.ascontiguousarray(xyz)), k).numpy()
    np.testing.assert_array_equal(got_idx, ref_idx)

    with torch.inference_mode():
        tout = tm(torch.from_numpy(ctx))
    eager = jm.apply({"params": jp}, jnp.asarray(ctx))
    jitted = jax.jit(lambda p, x: jm.apply({"params": p}, x))(jp, jnp.asarray(ctx))
    got = _logits(tout)
    med_eager, _ = _budget(got, _logits(eager), 3e-3)
    _budget(got, _logits(jitted), 3e-3)
    # the port evaluates flax's formulas op by op: next to eager apply it is
    # at f32 resolution
    assert med_eager < 1e-5, med_eager
    if isinstance(tout, dict) and "embedding" in tout:
        z = tout["embedding"].numpy()
        np.testing.assert_allclose(np.linalg.norm(z, axis=-1), 1.0, atol=1e-5)
        assert np.median(np.abs(z - np.asarray(eager["embedding"]))) < 1e-3


@pytest.mark.parametrize("form", ["class_global_embed", "seg_two_knn", "class_plain"])
def test_random_init_point_nets_match_flax(form):
    from syconn_tpu.models.pointnet import PointClassNet as JClass
    from syconn_tpu.models.pointnet import PointSegNet as JSeg
    from syconn_tpu_torch.models.convert import module_state_from_flax
    from syconn_tpu_torch.models.pointnet import PointClassNet, PointSegNet

    widths, k, npoints = (16, 32, 48), 8, 96
    if form == "class_global_embed":
        kw = dict(n_classes=5, widths=widths, k=k, embed_dim=6, n_global=3)
        jm, tm = JClass(**kw), PointClassNet(**kw)
        n_global = 3
    elif form == "seg_two_knn":
        kw = dict(n_classes=4, widths=widths, k=k, knn_stages=2)
        jm, tm = JSeg(**kw), PointSegNet(**kw)
        n_global = 0
    else:
        kw = dict(n_classes=3, widths=widths, k=k)
        jm, tm = JClass(**kw), PointClassNet(**kw)
        n_global = 0
    ctx = _contexts(npoints, 6, n_global, seed=5)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ctx))["params"]
    tree = jax.tree.map(np.asarray, params)
    tm.load_state_dict(module_state_from_flax(tree))
    with torch.inference_mode():
        tout = tm(torch.from_numpy(ctx))
    jout = jm.apply({"params": params}, jnp.asarray(ctx))
    _budget(_logits(tout), _logits(jout), 2e-2)
    if form == "class_global_embed":
        z = tout["embedding"].numpy()
        np.testing.assert_allclose(np.linalg.norm(z, axis=-1), 1.0, atol=1e-5)


def test_flax_gelu_is_nn_gelu_in_bf16():
    import flax.linen as nn

    from syconn_tpu_torch.models.pointnet import flax_gelu

    x = (np.random.default_rng(0).normal(size=20000) * 3).astype(np.float32)
    ref = np.asarray(nn.gelu(jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    got = flax_gelu(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, ref)
    ref32 = np.asarray(nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(flax_gelu(torch.from_numpy(x)).numpy(), ref32, rtol=1e-6,
                               atol=1e-6)


def test_missing_point_model_raises(tmp_path):
    from syconn_tpu_torch.inference.points import _get_point_model
    from syconn_tpu_torch.models.io import load_model

    with pytest.raises(FileNotFoundError):
        load_model(str(tmp_path / "no_such_model"))
    with pytest.raises(FileNotFoundError):
        _get_point_model(str(tmp_path / "models" / "glia_pts_unknown"))
