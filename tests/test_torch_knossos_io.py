"""KNOSSOS interchange and mesh voxelization of the port against the JAX
package on the CPU: snappy streams byte for byte (and the port decoding
every copy kind), ``knossos.conf`` and the cube files of an export equal
(the ``.raw`` cubes byte for byte, the ``.seg.sz.zip`` cubes member for
member: their zip headers carry the time of writing), imports into equal
volumes, and ``voxelize_mesh`` equal arrays on a toy-world cell. The
volumes are those of ``tests/test_knossos_io.py``."""

import os
import zipfile

import numpy as np
import pytest

from _torch_helpers import build_jax_sso_world


@pytest.mark.parametrize("n", [0, 1, 59, 60, 61, 1 << 8, (1 << 16) + 3, 300000])
def test_snappy_equals_jax(n):
    from syconn_tpu.io import snappy_py as jsnappy
    from syconn_tpu_torch.io import snappy_py

    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    stream = snappy_py.compress(data)
    assert stream == jsnappy.compress(data)
    assert snappy_py.decompress(stream) == data


def test_snappy_copies_and_errors():
    """The decoder on the three copy kinds, overlapping copies included, as
    the JAX package decodes them; a bad offset raises in both."""
    from syconn_tpu.io import snappy_py as jsnappy
    from syconn_tpu_torch.io import snappy_py

    streams = [
        # "ab", then copy(offset 2, length 6) with a 1-byte offset: "abababab"
        bytes([8]) + bytes([1 << 2]) + b"ab" + bytes([((6 - 4) << 2) | 1, 2]),
        # "abc", then copy(offset 3, length 9) with a 2-byte offset
        bytes([12]) + bytes([2 << 2]) + b"abc" + bytes([(8 << 2) | 2, 3, 0]),
        # "xyz!", then copy(offset 4, length 4) with a 4-byte offset
        bytes([8]) + bytes([3 << 2]) + b"xyz!" + bytes([(3 << 2) | 3, 4, 0, 0, 0]),
    ]
    expect = [b"abababab", b"abcabcabcabc", b"xyz!xyz!"]
    for s, e in zip(streams, expect):
        assert snappy_py.decompress(s) == jsnappy.decompress(s) == e
    bad = bytes([4]) + bytes([((6 - 4) << 2) | 1, 9])
    for mod in (snappy_py, jsnappy):
        with pytest.raises(ValueError):
            mod.decompress(bad)


def test_knossos_conf_equals_jax(tmp_path):
    from syconn_tpu.io import knossos as jk
    from syconn_tpu_torch.io import knossos as tk

    args = ("toy world", (512, 256, 128), (9.0, 9.0, 21.0))
    pj = jk.write_knossos_conf(str(tmp_path / "j"), *args, mag=2)
    pt = tk.write_knossos_conf(str(tmp_path / "t"), *args, mag=2)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    assert tk.parse_knossos_conf(str(tmp_path / "j")) == jk.parse_knossos_conf(pt) == {
        "experiment_name": "toy world", "boundary": [512, 256, 128],
        "scale": [9.0, 9.0, 21.0], "magnification": 2}


def _tree(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def test_knossos_export_import_equals_jax(tmp_path):
    """One volume in each package's chunk store, exported by each: the same
    files, equal contents; each package imports the other's export into the
    volume it started from."""
    from syconn_tpu.io import knossos as jk
    from syconn_tpu.io.chunked import ChunkedVolume as JCV
    from syconn_tpu_torch.io import knossos as tk
    from syconn_tpu_torch.io.chunked import ChunkedVolume

    rng = np.random.default_rng(1)
    shape = (150, 140, 70)  # not a multiple of the 128 cube edge
    raw = rng.integers(0, 256, shape).astype(np.uint8)
    seg = np.zeros(shape, np.uint64)
    seg[10:80, 20:90, 5:40] = 7
    seg[90:140, 30:120, 10:60] = (1 << 40) + 3  # a label beyond 32 bits
    kw = dict(scale=(10, 10, 20), boundary=shape, experiment_name="toy", chunk_shape=(64, 64, 32))
    cvs = {"j": JCV.create(str(tmp_path / "cv_j"), **kw),
           "t": ChunkedVolume.create(str(tmp_path / "cv_t"), **kw)}
    for cv in cvs.values():
        cv.save_raw(raw, mags=[1])
        cv.save_seg(seg, mags=[1])
    dirs = {}
    for w, exp in (("j", jk.export_to_knossos_dataset), ("t", tk.export_to_knossos_dataset)):
        dirs[w] = str(tmp_path / f"kns_{w}")
        for ch in ("raw", "seg"):
            exp(cvs[w], dirs[w], channel=ch)
    files = _tree(dirs["j"])
    assert files == _tree(dirs["t"])
    assert sum(f.endswith(".raw") for f in files) == 4
    assert sum(f.endswith(".seg.sz.zip") for f in files) == 2  # two cubes hold no label
    for f in files:
        pj, pt = os.path.join(dirs["j"], f), os.path.join(dirs["t"], f)
        if f.endswith(".zip"):
            with zipfile.ZipFile(pj) as zj, zipfile.ZipFile(pt) as zt:
                assert zj.namelist() == zt.namelist() == [os.path.basename(f)[:-4]]
                assert zj.read(zj.namelist()[0]) == zt.read(zt.namelist()[0])
        else:
            assert open(pj, "rb").read() == open(pt, "rb").read()
    for src in ("j", "t"):
        r = tk.import_knossos_dataset(dirs[src], str(tmp_path / f"raw_{src}"), channel="raw",
                                      chunk_shape=(64, 64, 64))
        s = tk.import_knossos_dataset(dirs[src], str(tmp_path / f"seg_{src}"), channel="seg")
        jr = jk.import_knossos_dataset(dirs[src], str(tmp_path / f"jraw_{src}"), channel="raw")
        assert np.array_equal(r.load_raw(size=shape), raw)
        assert np.array_equal(s.load_seg(size=shape), seg)
        assert np.array_equal(jr.load_raw(size=shape), raw)
        assert r.experiment_name == "toy" and list(r.scale) == [10.0, 10.0, 20.0]


@pytest.mark.parametrize("solid", [True, False])
def test_voxelize_mesh_equals_jax(tmp_path, solid):
    """A toy-world cell's merged ``sv`` mesh voxelized by both packages, the
    whole cell and a crop cutting it open: equal volumes; the solid whole
    cell lies on the cell's own segmentation."""
    from syconn_tpu.mesh.voxelize import sample_mesh_surface as jsample
    from syconn_tpu.mesh.voxelize import voxelize_mesh as jvox
    from syconn_tpu.reps.super_segmentation import SuperSegmentationDataset as JSSD
    from syconn_tpu_torch.mesh.voxelize import sample_mesh_surface, voxelize_mesh

    wd = build_jax_sso_world(tmp_path)
    ssd = JSSD(working_dir=wd)
    sso = ssd.get_super_segmentation_object(int(ssd.ssv_ids[0]))
    ind, vert = sso.load_mesh("sv")[:2]
    scale = np.array([10.0, 10.0, 20.0])
    np.testing.assert_array_equal(sample_mesh_surface(ind, vert, 5.0, seed=3),
                                  jsample(ind, vert, 5.0, seed=3))
    for offset, shape in (((0, 0, 0), (96, 96, 48)), ((300, 200, 100), (40, 30, 20))):
        got = voxelize_mesh(ind, vert, scale, offset, shape, solid=solid, seed=1)
        ref = jvox(ind, vert, scale, offset, shape, solid=solid, seed=1)
        assert got.dtype == ref.dtype == bool and got.any()
        np.testing.assert_array_equal(got, ref)
    if solid:
        from scipy import ndimage

        from syconn_tpu.handler.basics import kd_factory

        # the toy cells fill the volume and their meshes are open at its
        # faces, so the fill closes little: the shell is held to the cell
        # (within one voxel of its segmentation)
        kd = kd_factory(os.path.join(wd, "knossosdatasets", "seg"))
        cell = np.isin(kd.load_seg(size=(96, 96, 48)), [int(s) for s in sso.sv_ids])
        vol = voxelize_mesh(ind, vert, scale, (0, 0, 0), (96, 96, 48), seed=1)
        near = (vol & ndimage.binary_dilation(cell)).sum() / vol.sum()
        assert near > 0.95, near
