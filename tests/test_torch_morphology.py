"""The port's device morphology (``ops/morphology_torch.py``) and its host
helpers (``ops/morphology.py``) against the JAX package on the CPU.

Exact (``array_equal``) at sigma 0: the structuring-element counts are
integers in float32 in both packages. At sigma 1.5 the blur is a float sum
in another order, so a threshold may flip, but only where the blurred value
is within 1e-3 of the threshold and on fewer than 1e-4 of the voxels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syconn_tpu.ops import morphology as jmorph
from syconn_tpu.ops import morphology_jax as jdev
from syconn_tpu_torch.ops import morphology as tmorph
from syconn_tpu_torch.ops import morphology_torch as tdev


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU: torch's
    default of one thread per core in every process oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

STRUCT = jmorph.get_aniso_struct((10, 10, 20))

# tests/test_kernels_device.py:102-104, then the extract_morph_op chains of
# syconn_tpu/handler/default_config.yml:119-124 (mi, vc/sj, er/golgi, and
# the chain without its trailing erosions)
CHAINS = [
    ["binary_dilation"],
    ["binary_erosion"],
    ["binary_opening", "binary_closing"],
    ["binary_closing", "binary_erosion", "binary_erosion"],
    ["binary_opening", "binary_closing"] + ["binary_erosion"] * 4,
    ["binary_opening", "binary_closing", "binary_erosion"],
    ["binary_dilation"] * 3 + ["binary_erosion"] * 3,
    [],
]


@pytest.mark.parametrize("ops", CHAINS, ids=lambda o: "+".join(x[7:] for x in o) or "none")
def test_morphology_chain_matches_jax_and_scipy(ops):
    mask = np.random.default_rng(0).random((32, 28, 20)) < 0.4
    got = tdev.morphology_chain_device(mask, ops, STRUCT, device="cpu")
    assert got.dtype == bool
    assert np.array_equal(got, jdev.morphology_chain_device(mask, ops, STRUCT))
    assert np.array_equal(got, jmorph.apply_morphological_operations(mask.copy(), ops,
                                                                     struct=STRUCT))


def _prob(shape=(40, 36, 22), seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("ops", CHAINS[4:7], ids=["mi", "vc", "er"])
def test_segment_chunk_and_packed_bytes_match_jax(ops):
    prob = _prob()
    ref = jdev.segment_chunk_device(prob, 110.0, ops, STRUCT)
    got = tdev.segment_chunk_device(prob, 110.0, ops, STRUCT, device="cpu")
    assert got[2] == ref[2]
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    pre, n_tr = jdev._split_ops(ops)
    assert tdev._split_ops(ops) == (pre, n_tr)
    for sz in (22, 21):  # z padded to a multiple of 4 or not
        p = prob[:, :, :sz]
        ref_b = np.asarray(jdev._segment_chunk_packed(jnp.asarray(p), 110.0, jnp.asarray(STRUCT),
                                                      pre, n_tr, STRUCT.shape, 0.0))
        got_b = tdev._segment_chunk_packed(torch.from_numpy(p), 110.0, torch.from_numpy(STRUCT),
                                           pre, n_tr, 0.0)
        assert got_b.dtype == torch.uint8 and np.array_equal(got_b.numpy(), ref_b)


def test_blurred_threshold_flips_only_at_the_threshold():
    prob = np.random.default_rng(2).integers(0, 256, (48, 40, 32)).astype(np.uint8)
    thr = 128.0
    ref, _, _ = jdev.segment_chunk_device(prob, thr, [], STRUCT, sigma=1.5)
    got, _, _ = tdev.segment_chunk_device(prob, thr, [], STRUCT, sigma=1.5, device="cpu")
    blur = tdev._blur(torch.from_numpy(prob).float(), 1.5).numpy()
    flips = got != ref
    assert np.all(np.abs(blur[flips] - thr) < 1e-3)
    assert flips.mean() < 1e-4


def test_host_helpers_match_jax():
    x = _prob((20, 18, 12), 3)
    assert np.array_equal(tmorph.gaussian_blur(x, 1.2), jmorph.gaussian_blur(x, 1.2))
    for ops in CHAINS:
        for sigma in (0, 1.5, (1.0, 1.0, 0.5)):
            for ext in (1, 2):
                assert tmorph.morphology_halo(ops, sigma, ext) == \
                    jmorph.morphology_halo(ops, sigma, ext)


def test_resident_segmenter_matches_jax_and_the_streaming_windows():
    sh = (70, 45, 37)  # not a multiple of the chunk on any axis
    prob = np.random.default_rng(4).integers(0, 256, sh).astype(np.uint8)
    chunk, ops = (32, 32, 16), CHAINS[5]
    halo = jmorph.morphology_halo(ops, 0, 2)
    jseg = jdev.ResidentSegmenter(jnp.asarray(prob), chunk, halo, 72.0, ops, STRUCT)
    tseg = tdev.ResidentSegmenter(torch.from_numpy(prob), chunk, halo, 72.0, ops, STRUCT)
    padded = np.pad(prob, halo + 32)
    for cix in [(0, 0, 0), (1, 0, 1), (2, 1, 2)]:
        got = tseg.fetch(tseg.dispatch(cix))
        ref = jseg.fetch(jseg.dispatch(cix))
        assert got[2] == ref[2] == 1
        off = np.array(cix) * chunk
        size = np.minimum(chunk, np.array(sh) - off)
        assert got[0].shape == tuple(size + 2 * halo)
        assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
        lo = off - halo + halo + 32
        win = padded[lo[0]:lo[0] + size[0] + 2 * halo, lo[1]:lo[1] + size[1] + 2 * halo,
                     lo[2]:lo[2] + size[2] + 2 * halo]
        stream = tdev.segment_chunk_device(win, 72.0, ops, STRUCT, device="cpu")
        assert np.array_equal(got[0], stream[0]) and np.array_equal(got[1], stream[1])


def test_even_structuring_element_is_refused():
    with pytest.raises(ValueError, match="odd"):
        tdev.morphology_chain_device(np.zeros((8, 8, 8), bool), ["binary_erosion"],
                                     np.ones((2, 3, 3), bool), device="cpu")
