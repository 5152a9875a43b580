"""The port's connected components (``ops/cc_torch.py``) and host labeling
helpers (``ops/cc.py``) against the JAX package on the CPU.

Every comparison is exact (``array_equal``): the device labels are flat
indices + 1 of each component's first voxel in both packages, the compact
labels follow scipy's first-occurrence numbering.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syconn_tpu.ops import cc as jcc
from syconn_tpu.ops.cc_jax import connected_components_device as jax_cc_device
from syconn_tpu.ops.cc_jax import connected_components_tpu
from syconn_tpu_torch.ops import cc as tcc
from syconn_tpu_torch.ops.cc_torch import (connected_components_device,
                                           connected_components_torch)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU: torch's
    default of one thread per core in every process oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _serpentine():
    m = np.zeros((32, 32, 4), bool)
    for i in range(0, 32, 2):
        m[i, :, :] = True
        if (i // 2) % 2 == 0:
            m[i + 1, -1, :] = True
        elif i + 1 < 32:
            m[i + 1, 0, :] = True
    return m


def _diagonal_lines():
    m = np.zeros((10, 10, 10), bool)
    m[2, 2, :] = True
    m[3, 3, :] = True
    return m


# the masks of tests/test_kernels_device.py::test_connected_components_device_golden
MASKS = {
    **{f"random_p{p}": (lambda p=p: np.random.default_rng(0).random((24, 20, 16)) < p)
       for p in (0.05, 0.3, 0.6, 0.9)},
    "serpentine": _serpentine,
    "diagonal_lines": _diagonal_lines,
    "empty": lambda: np.zeros((8, 8, 8), bool),
    "full": lambda: np.ones((8, 8, 8), bool),
    "thin_axis": lambda: np.random.default_rng(1).random((1, 17, 9)) < 0.6,
}


@pytest.mark.parametrize("name", sorted(MASKS))
def test_device_labels_match_jax(name):
    mask = MASKS[name]()
    ref = np.asarray(jax_cc_device(jnp.asarray(mask)))
    got = connected_components_device(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name", sorted(MASKS))
def test_compact_labels_match_jax_and_scipy(name):
    mask = MASKS[name]()
    lab_s, n_s = jcc.connected_components(mask, device=False)
    lab_j, n_j = connected_components_tpu(mask)
    lab_t, n_t = connected_components_torch(mask, device="cpu")
    assert n_t == n_j == n_s
    assert lab_t.dtype == np.uint32
    assert np.array_equal(lab_t, lab_j) and np.array_equal(lab_t, lab_s)
    # the dispatcher: a torch device, or scipy with device=False
    for device in (False, "cpu"):
        lab, n = tcc.connected_components(mask, device=device)
        assert n == n_s and lab.dtype == np.uint32 and np.array_equal(lab, lab_s)
    if name == "diagonal_lines":
        assert n_t == 2  # 6-connectivity: diagonal neighbours stay apart


def _seeded_blobs(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.zeros((40, 32, 24), bool)
    seeds = np.zeros(mask.shape, np.uint32)
    for k in range(6):
        c = rng.integers(6, [34, 26, 18])
        r = rng.integers(3, 7, 3)
        sl = tuple(slice(int(c[i] - r[i]), int(c[i] + r[i])) for i in range(3))
        mask[sl] = True
        seeds[tuple(slice(int(c[i]) - 1, int(c[i]) + 1) for i in range(3))] = k + 1
    return mask, seeds


def test_watershed_helpers_match_jax():
    mask, seeds = _seeded_blobs()
    assert np.array_equal(tcc.watershed_from_seeds(mask, seeds),
                          jcc.watershed_from_seeds(mask, seeds))
    for sampling in (None, (10, 10, 20)):
        assert np.array_equal(tcc.watershed_distance(mask, seeds, sampling=sampling),
                              jcc.watershed_distance(mask, seeds, sampling=sampling))


def test_stitch_helpers_match_jax():
    rng = np.random.default_rng(2)
    local = rng.integers(0, 5, (6, 7, 8)).astype(np.uint32)
    for cix in (0, 3, 200):
        got = tcc.encode_chunk_labels(local, cix)
        assert got.dtype == np.uint64 and np.array_equal(got, jcc.encode_chunk_labels(local, cix))
    assert int(tcc.CHUNK_LABEL_STRIDE) == 2**24 == int(jcc.CHUNK_LABEL_STRIDE)
    fa = tcc.encode_chunk_labels(rng.integers(0, 4, (9, 9)).astype(np.uint32), 0)
    fb = tcc.encode_chunk_labels(rng.integers(0, 4, (9, 9)).astype(np.uint32), 1)
    pairs = tcc.face_merge_pairs(fa, fb)
    assert np.array_equal(pairs, jcc.face_merge_pairs(fa, fb))
    assert tcc.face_merge_pairs(fa * 0, fb).shape == (0, 2)
    labels = np.unique(np.concatenate([fa.ravel(), fb.ravel()]))
    labels = labels[labels != 0]
    for compact in (True, False):
        assert tcc.merge_pairs_to_map(labels, pairs, compact=compact) == \
            jcc.merge_pairs_to_map(labels, pairs, compact=compact)
    uf = tcc.UnionFind(labels)
    with pytest.raises(KeyError):
        uf.union_pairs(np.array([[labels.max() + 1, labels[0]]], np.uint64))
