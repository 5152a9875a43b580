"""The port's pure-Python msgpack reader against flax and msgpack."""

import os

import msgpack
import numpy as np
import pytest
from flax import serialization

from syconn_tpu.models import io as jio
from syconn_tpu_torch.models import io as tio
from syconn_tpu_torch.models.msgpack_io import msgpack_restore, unpackb

PACKAGED = ["celltype_pts", "compartment_pts", "er", "glia_pts", "golgi", "myelin",
            "organelles", "spiness", "syntype", "tnet_pts"]


def _assert_same_tree(got, ref, path=""):
    assert type(got) is type(ref) or (isinstance(ref, np.ndarray) and isinstance(got, np.ndarray)), path
    if isinstance(ref, dict):
        assert list(got.keys()) == list(ref.keys()), path
        for k in ref:
            _assert_same_tree(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        assert got.tobytes() == ref.tobytes(), path  # bit-identical
    else:
        assert got == ref, path


@pytest.mark.parametrize("name", PACKAGED)
def test_reader_matches_flax_on_packaged_weights(name):
    p = os.path.join(tio.packaged_model_path(name), "params.msgpack")
    assert os.path.samefile(p, os.path.join(jio.packaged_model_path(name), "params.msgpack"))
    with open(p, "rb") as f:
        raw = f.read()
    _assert_same_tree(msgpack_restore(raw), serialization.msgpack_restore(raw))


def test_reader_matches_msgpack_on_every_type():
    """Every msgpack format the reader claims: fix/8/16/32-bit ints of both
    signs, f32/f64, nil/bool, str and bin of all length classes, arrays
    and maps of 16+ and 65536+ entries, and ext."""
    obj = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1,
                 -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
        "floats": [0.5, -1.25e300, float("inf")],
        "misc": [None, True, False],
        "strs": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000],
        "bins": [b"", b"x" * 300, b"y" * 70000],
        "long": list(range(20)), "longer": list(range(70000)),
        "map": {f"k{i}": i for i in range(20)},
        "nested": {"deep": {"list": [{"a": 1}, [2, [3]]]}},
    }
    buf = msgpack.packb(obj, use_bin_type=True)
    assert unpackb(buf) == msgpack.unpackb(buf, raw=False)
    f32 = msgpack.packb(np.float32(1.5).item(), use_single_float=True)
    assert unpackb(f32) == 1.5
    for n in (1, 2, 4, 8, 16, 3, 300, 70000):
        ext = msgpack.packb(msgpack.ExtType(5, b"z" * n))
        assert unpackb(ext) == (5, b"z" * n)


def test_reader_restores_flax_special_leaves():
    """Scalars, complex values and chunked arrays round-trip as flax does."""
    tree = {"a": np.arange(12, dtype=np.int16).reshape(3, 4), "s": np.float32(2.5),
            "c": complex(1.0, -2.0), "n": {"x": np.zeros((0, 3), np.float64)}}
    raw = serialization.msgpack_serialize(tree)
    _assert_same_tree(msgpack_restore(raw), serialization.msgpack_restore(raw))
    chunked = {"big": {"__msgpack_chunked_array__": True, "shape": {"0": 2, "1": 3},
                       "chunks": {"0": np.arange(4.0), "1": np.arange(4.0, 6.0)}}}
    got = msgpack_restore(serialization.msgpack_serialize(chunked))
    np.testing.assert_array_equal(got["big"], np.arange(6.0).reshape(2, 3))


def test_load_model_meta_and_model_match_jax():
    meta = tio.load_model_meta(tio.packaged_model_path("myelin"))
    assert meta == jio.load_model_meta(jio.packaged_model_path("myelin"))
    assert meta["threshold"] == 248
    model, params = tio.load_model(tio.packaged_model_path("myelin"))
    jmodel, _ = jio.load_model(jio.packaged_model_path("myelin"))
    assert model.features == tuple(jmodel.features) and model.n_classes == jmodel.n_classes
    assert model.patch == tuple(jmodel.patch)
    assert model.strides == tuple(tuple(s) for s in jmodel.strides)
    # the module's state carries every leaf of the tree, kernels as OIDHW
    w = params["ConvBlock_0"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(
        model.ConvBlock_0.Conv_0.weight.detach().numpy(), np.transpose(w, (4, 3, 0, 1, 2)))
    assert tio.model_exists(tio.packaged_model_path("syntype"))
    assert tio.load_model_meta("/nonexistent/nothing") == {}
