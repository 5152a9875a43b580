"""The port's meshing (``mesh/surface_nets.py``, ``proc/meshes.py``)
against the JAX package on seeded label chunks: the same numpy code, so
every mesh is equal bit for bit."""

import numpy as np
import pytest

from syconn_tpu.mesh import surface_nets as jsn
from syconn_tpu.proc import meshes as jm
from syconn_tpu_torch.handler.basics import read_txt_from_zip
from syconn_tpu_torch.mesh import surface_nets as tsn
from syconn_tpu_torch.proc import meshes as tm


def _labels(seed, shape=(40, 36, 20)):
    """Blocks of random ids (some above 2**32), ellipsoids, background."""
    rng = np.random.default_rng(seed)
    vol = np.repeat(np.repeat(np.repeat(rng.choice(
        [0, 3, 17, 2**33 + 5, 99], size=(5, 4, 3)), 8, 0), 9, 1), 7, 2)[:shape[0], :shape[1],
                                                                     :shape[2]]
    vol = np.ascontiguousarray(vol).astype(np.uint64)
    x, y, z = np.ogrid[:shape[0], :shape[1], :shape[2]]
    vol[((x - 20) / 9.0) ** 2 + ((y - 18) / 7.0) ** 2 + ((z - 10) / 4.0) ** 2 <= 1] = 42
    return vol


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("ds,simplify", [((1, 1, 1), 0.0), ((4, 4, 2), 0.0), ((2, 2, 1), 40.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_find_meshes_equal_jax(seed, ds, simplify):
    vol = _labels(seed)
    off, scale = (64, 32, 16), (10, 10, 20)
    got = tm.find_meshes(vol, off, scale, downsampling=ds, simplify_nm=simplify)
    ref = jm.find_meshes(vol, off, scale, downsampling=ds, simplify_nm=simplify)
    assert sorted(got) == sorted(ref) and 42 in got
    for oid in ref:
        _equal(got[oid], ref[oid])
    sel = tm.find_meshes(vol, off, scale, obj_ids=[3, 42])
    assert sorted(sel) == sorted(jm.find_meshes(vol, off, scale, obj_ids=[3, 42]))


def test_merge_meshes_and_area_equal_jax():
    vol = _labels(2)
    frags = [tm.find_meshes(vol[:20], (0, 0, 0), (10, 10, 20))[42],
             tm.find_meshes(vol[20:], (20, 0, 0), (10, 10, 20))[42],
             [np.zeros(0, np.int32), np.zeros(0, np.float32), np.zeros(0, np.float32)]]
    got, ref = tm.merge_meshes(frags), jm.merge_meshes(frags)
    _equal(got, ref)
    assert tm.mesh_area_calc(got) == jm.mesh_area_calc(ref) > 0
    assert tsn.mesh_area(got[0], got[1]) == jsn.mesh_area(ref[0], ref[1])
    _equal(tm.merge_meshes([]), jm.merge_meshes([]))
    ind, vert, _ = frags[0]
    _equal(tsn.simplify_mesh(ind, vert, 30.0), jsn.simplify_mesh(ind, vert, 30.0))
    mask = vol == 17
    _equal(tsn.surface_net_mesh(mask, (1, 2, 3), (10, 10, 20), (2, 2, 1)),
           jsn.surface_net_mesh(mask, (1, 2, 3), (10, 10, 20), (2, 2, 1)))


def test_write_mesh2kzip_equals_jax(tmp_path):
    ind, vert, norm = tm.find_meshes(_labels(3), (0, 0, 0), (10, 10, 20))[42]
    tm.write_mesh2kzip(str(tmp_path / "t.k.zip"), ind, vert, norm, None, "m.ply")
    jm.write_mesh2kzip(str(tmp_path / "j.k.zip"), ind, vert, norm, None, "m.ply")
    got = read_txt_from_zip(str(tmp_path / "t.k.zip"), "m.ply")
    assert got == read_txt_from_zip(str(tmp_path / "j.k.zip"), "m.ply")
    assert got.startswith(b"ply\n")
