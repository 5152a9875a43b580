"""Standalone cells and kzip archives of the port against the JAX package on
the CPU: the skeleton NML text byte for byte, the seven kzip methods of
``SuperSegmentationObject`` member for member, archives of either package
(and of the reference's layout) read by the other with equal meshes,
skeletons and ``sv_ids``, and a loaded cell that needs no working
directory. The cells are those of ``tests/test_sso_methods.py::sso_world``,
built by the JAX package; each package works on its own copy of the
working directory (both cache sample locations and meshes there)."""

import io
import json
import os
import pickle
import shutil
import zipfile

import numpy as np
import pytest

from _torch_helpers import _same, build_jax_sso_world

pytest.importorskip("networkx")

METHODS = ["skeleton_to_kzip", "mesh2kzip", "meshes2kzip", "export2kzip", "mergelist2kzip",
           "write_locations2kzip", "write_svmeshes2kzip"]


@pytest.fixture(scope="module")
def two_wds(tmp_path_factory):
    """(JAX working directory, the port's copy of it, the cell ids)."""
    from syconn_tpu.reps.super_segmentation import SuperSegmentationDataset as JSSD

    root = tmp_path_factory.mktemp("kzip_world")
    wj = build_jax_sso_world(root)
    wt = str(root / "wd_port")
    shutil.copytree(wj, wt)
    ids = [int(i) for i in JSSD(working_dir=wj).ssv_ids]
    assert len(ids) == 2
    return wj, wt, ids


def _cells(wj, wt, ssv_id):
    from syconn_tpu.reps.super_segmentation import SuperSegmentationDataset as JSSD
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset

    return (JSSD(working_dir=wj).get_super_segmentation_object(ssv_id),
            SuperSegmentationDataset(working_dir=wt).get_super_segmentation_object(ssv_id))


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return [(i.filename, zf.read(i.filename)) for i in zf.infolist()]


def _same_member(name, a, b):
    """Text members byte for byte; numpy archives (whose zip headers carry
    the time of writing) array for array; pickles by value."""
    if name.endswith(".npz"):
        with np.load(io.BytesIO(a)) as za, np.load(io.BytesIO(b)) as zb:
            assert za.files == zb.files, name
            for k in za.files:
                _same(za[k], zb[k], f"{name}/{k}")
    elif name.endswith(".pkl"):
        _same(pickle.loads(a), pickle.loads(b), name)
    else:
        assert a == b, name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skeleton_nml_equals_jax(tmp_path, seed):
    from syconn_tpu.skeleton import io as jio
    from syconn_tpu_torch.skeleton import io as tio

    rng = np.random.default_rng(seed)
    n = [0, 1, 57][seed]
    skel = {"nodes": (rng.random((n, 3)) * 500).astype(np.float32),
            "edges": np.stack([np.arange(max(n - 1, 0)), np.arange(1, n)], 1).astype(np.int64),
            "diameters": (rng.random(n) * 30).astype(np.float32)}
    if seed == 2:
        del skel["diameters"]  # radius 0 for every node
    kw = dict(scaling=(10, 10, 20), comment=f"cell {seed}")
    nml = tio.skeleton_to_nml(skel, **kw)
    assert nml == jio.skeleton_to_nml(skel, **kw)
    back, jback = tio.nml_to_skeleton(nml), jio.nml_to_skeleton(nml)
    _same(back, jback)
    np.testing.assert_allclose(back["nodes"], np.round(skel["nodes"], 1), atol=0.051)
    tio.skeleton_to_kzip(skel, str(tmp_path / "t.k.zip"), **kw)
    jio.skeleton_to_kzip(skel, str(tmp_path / "j.k.zip"), **kw)
    assert _members(str(tmp_path / "t.k.zip")) == _members(str(tmp_path / "j.k.zip"))


@pytest.mark.parametrize("method", METHODS)
def test_kzip_methods_equal_jax(two_wds, tmp_path, method):
    """Every cell, each method into a fresh archive: the same members in the
    same order with equal contents."""
    wj, wt, ids = two_wds
    for ssv_id in ids:
        jsso, tsso = _cells(wj, wt, ssv_id)
        paths = [str(tmp_path / f"{w}_{ssv_id}.k.zip") for w in ("j", "t")]
        for sso, p in zip((jsso, tsso), paths):
            getattr(sso, method)(p)
        mj, mt = _members(paths[0]), _members(paths[1])
        assert [m[0] for m in mj] == [m[0] for m in mt]
        assert mj, method
        for (name, a), (_, b) in zip(mj, mt):
            _same_member(name, a, b)


def test_archives_cross_read(two_wds, tmp_path):
    """A JAX-written archive loads in the port and a port-written one in the
    JAX package: meshes, skeleton, ``sv_ids``, attributes and scaling equal
    the working directory's."""
    from syconn_tpu.proc.ssd_assembly import init_sso_from_kzip as jinit
    from syconn_tpu.proc.ssd_assembly import init_ssd_from_kzips as jinit_dir
    from syconn_tpu_torch.proc.ssd_assembly import init_sso_from_kzip, init_ssd_from_kzips

    wj, wt, ids = two_wds
    for w in ("j", "t"):
        os.makedirs(tmp_path / w)
    for ssv_id in ids:
        jsso, tsso = _cells(wj, wt, ssv_id)
        pj = jsso.export2kzip(str(tmp_path / "j" / f"{ssv_id}.k.zip"))
        pt = tsso.export2kzip(str(tmp_path / "t" / f"{ssv_id}.k.zip"))
        for loaded in (init_sso_from_kzip(pj), jinit(pt)):
            assert loaded.id == ssv_id and loaded._standalone
            assert np.asarray(loaded.sv_ids).tolist() == jsso.sv_ids.tolist()
            np.testing.assert_array_equal(loaded.scaling, jsso.scaling)
            for t in ("sv", "mi", "vc", "sj", "syn_ssv"):
                ref = jsso.load_mesh(t)
                got = loaded.load_mesh(t)
                if len(ref[1]) == 0:
                    assert len(got[1]) == 0
                    continue
                for a, b in zip(got, ref):
                    _same(np.asarray(a), np.asarray(b), t)
            assert loaded.load_skeleton() and jsso.load_skeleton()
            _same({k: np.asarray(v) for k, v in loaded.skeleton.items()},
                  {k: np.asarray(v) for k, v in jsso.skeleton.items()})
            jsso.load_attr_dict()
            _same(loaded.attr_dict, jsso.attr_dict)
    for d, load in ((tmp_path / "j", init_ssd_from_kzips), (tmp_path / "t", jinit_dir)):
        assert [c.id for c in load(str(d))] == sorted(ids)


def _ply_bytes(ind, vert):
    v = np.asarray(vert, "<f4").reshape(-1, 3)
    f = np.asarray(ind, np.int64).reshape(-1, 3)
    head = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(v)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(f)}\nproperty list uchar int vertex_indices\nend_header\n")
    rec = np.zeros((len(f), 13), np.uint8)
    rec[:, 0] = 3
    rec[:, 1:] = f.astype("<i4").view(np.uint8).reshape(len(f), 12)
    return head.encode() + v.tobytes() + rec.tobytes()


def test_reference_layout_archive_loads_alike(tmp_path):
    """An archive of the reference's layout (``meta.pkl``, binary PLY meshes,
    ``skeleton.pkl``, ``sample_locations.pkl``, ``mergelist.txt``) loads
    alike in both packages."""
    from syconn_tpu.proc.ssd_assembly import init_sso_from_kzip as jinit
    from syconn_tpu_torch.proc.ssd_assembly import init_sso_from_kzip, read_ply_bytes

    rng = np.random.default_rng(5)
    vert = (rng.random((40, 3)) * 2000).astype(np.float32)
    ind = rng.integers(0, 40, (30, 3))
    mi_vert = (rng.random((9, 3)) * 900).astype(np.float32)
    mi_ind = rng.integers(0, 9, (4, 3))
    skel = {"nodes": rng.random((6, 3)).astype(np.float32) * 100,
            "edges": np.array([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5]], np.int64),
            "diameters": np.ones(6, np.float32)}
    locs = [rng.random((3, 3)) * 2000, rng.random((2, 3)) * 2000]
    path = str(tmp_path / "ref.k.zip")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("meta.pkl", pickle.dumps({"sso_id": 491, "scaling": (10.0, 10.0, 25.0)}))
        zf.writestr("sv.ply", _ply_bytes(ind, vert))
        zf.writestr("mi.ply", _ply_bytes(mi_ind, mi_vert))
        zf.writestr("skeleton.pkl", pickle.dumps(skel))
        zf.writestr("sample_locations.pkl", pickle.dumps(locs))
        zf.writestr("mergelist.txt", "491 0 0 17 23 99\n10 20 30\n\n\n")
    ri, rv = read_ply_bytes(_ply_bytes(ind, vert))
    assert ri.tolist() == ind.ravel().tolist() and np.array_equal(rv, vert.ravel())
    got, ref = init_sso_from_kzip(path), jinit(path)
    assert got.id == ref.id == 491
    assert got.sv_ids.tolist() == ref.sv_ids.tolist() == [17, 23, 99]
    np.testing.assert_array_equal(got.scaling, ref.scaling)
    for t in ("sv", "mi", "vc"):
        for a, b in zip(got.load_mesh(t), ref.load_mesh(t)):
            _same(np.asarray(a), np.asarray(b), t)
    _same(got.skeleton, ref.skeleton)
    _same(got.attr_dict, ref.attr_dict)
    assert len(got.sample_locations()) == 2


def test_loaded_cell_needs_no_working_directory(two_wds, tmp_path, monkeypatch):
    """With no working directory set anywhere, a loaded cell answers from
    its archive: meshes (empty for a type it lacks), skeleton, ``sv_ids``,
    sample locations; nothing is written beside the process."""
    from syconn_tpu_torch import global_params
    from syconn_tpu_torch.proc.ssd_assembly import init_sso_from_kzip

    wj, wt, ids = two_wds
    _, tsso = _cells(wj, wt, ids[0])
    locs = tsso.sample_locations()
    tsso.attr_dict["sample_locations"] = locs
    path = tsso.export2kzip(str(tmp_path / "cell.k.zip"))
    cwd = tmp_path / "cwd"
    os.makedirs(cwd)
    monkeypatch.chdir(cwd)
    # no working directory anywhere: a fresh config of the packaged defaults
    monkeypatch.setattr(global_params, "wd", None)
    monkeypatch.setattr(global_params, "config", None)
    global_params._init_config()
    assert global_params.config.working_dir in (None, "")
    cell = init_sso_from_kzip(path)
    assert cell.working_dir in (None, "")
    assert len(cell.load_mesh("sv")[1]) == len(tsso.load_mesh("sv")[1]) > 0
    assert len(cell.load_mesh("mi")[1]) == 0 and len(cell.load_mesh("sj")[0]) == 0
    assert cell.load_skeleton() and len(cell.skeleton["nodes"]) > 0
    assert cell.sv_ids.tolist() == tsso.sv_ids.tolist()
    for a, b in zip(cell.sample_locations(), locs):
        np.testing.assert_array_equal(a, b)
    meta = json.loads(zipfile.ZipFile(path).read("meta.json"))
    assert meta == {"id": ids[0], "scaling": [10.0, 10.0, 20.0]}
    assert os.listdir(cwd) == []
