"""The reference-shaped names the copied host modules had left out, each
against the JAX package on the same seeded inputs, exactly: the 64-bit
contact route and the config stencil of ``ops/contacts.py``,
``map_subcell_extract_props``, ``proc/image.py``, ``get_object_mesh``,
``assign_rep_values``, the ``handler/basics.py`` helpers, ``register_model``,
``step_cache_dir``/``StepCache.clear`` and the aliases and re-exports. Last,
every module of the JAX package has the same public top-level names in the
port, less the deliberate exclusions listed here."""

import ast
import contextlib
import os
import zipfile

import numpy as np
import pytest
import torch

from _torch_helpers import _same, jax_defaults_isolated, port_wd
from syconn_tpu.ops import contacts as jcontacts
from syconn_tpu_torch.ops import contacts as tcontacts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX modules whose port has another name (the device formulations)
RENAMED = {"ops/cc_jax.py": "ops/cc_torch.py", "ops/contacts_jax.py": "ops/contacts_torch.py",
           "ops/morphology_jax.py": "ops/morphology_torch.py",
           "ops/props_jax.py": "ops/props_torch.py",
           "ops/contacts_pallas.py": "ops/contacts_cuda.py",
           "ops/conv3d_pallas.py": "ops/conv3d.py"}
# deliberately not ported: the relay-attached TPU's gates and probes, and
# the re-exports of JAX's sharding types
NOT_PORTED = {"utils/jaxcfg.py", "utils/linkprobe.py", "utils/linkcfg.py"}
EXCLUDED = {"io/resident.py": {"trip", "tripped", "timed_fetch"},
            "parallel/device.py": {"NamedSharding", "P"}}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def jax_wd(wd):
    """``port_wd`` for the JAX package: its ``DynConfig`` also keeps its last
    working directory when ``wd`` goes back, so it is replaced afterwards."""
    from syconn_tpu import global_params as jparams

    prev = jparams.wd
    jparams.wd = wd
    try:
        yield jparams.config
    finally:
        jparams.wd = prev
        jparams.config = None
        jparams._init_config()


def _public_names(path):
    """Top-level defs, classes and assignments, ``__all__``, and the imports
    marked as re-exports (``noqa: F401``); names without a leading ``_``."""
    with open(path) as f:
        src = f.read()
    lines = src.splitlines()
    out = set()
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for tg in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                if isinstance(tg, ast.Name):
                    out.add(tg.id)
                    if tg.id == "__all__":
                        out |= set(ast.literal_eval(node.value))
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and \
                "noqa: F401" in lines[node.lineno - 1]:
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in out if not n.startswith("_")}


def test_every_module_has_the_public_names_of_the_jax_package():
    jroot, troot = os.path.join(ROOT, "syconn_tpu"), os.path.join(ROOT, "syconn_tpu_torch")
    missing = {}
    for dirpath, _, files in os.walk(jroot):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fname), jroot).replace(os.sep, "/")
            if rel in NOT_PORTED:
                assert not os.path.exists(os.path.join(troot, rel)), rel
                continue
            port = os.path.join(troot, RENAMED.get(rel, rel))
            assert os.path.isfile(port), f"no counterpart of {rel}"
            if rel in RENAMED:
                continue
            gap = _public_names(os.path.join(jroot, rel)) - _public_names(port)
            if gap != EXCLUDED.get(rel, set()):
                missing[rel] = sorted(gap)
    assert not missing, missing


# ---------------------------------------------------------------- contacts
@pytest.fixture(params=["native", "numpy"])
def route(request, monkeypatch):
    """Both packages on their host library, or both on their numpy version."""
    from syconn_tpu_torch.utils.native import get_native

    if request.param == "numpy":
        monkeypatch.setattr(jcontacts, "get_native", lambda: None)
        monkeypatch.setattr(tcontacts, "get_native", lambda: None)
    else:
        assert get_native() is not None
    return request.param


def test_host_library_binds_the_64bit_kernels():
    """The library builds from the port's sources and binds both uint64
    symbols (a missing one would raise, not turn the library off)."""
    from syconn_tpu_torch.utils import native

    lib = native.get_native()
    assert lib is not None and not native._failed
    for name in ("detect_seg_boundaries_u64", "detect_contact_partners_u64"):
        assert getattr(lib, name).restype is None


@pytest.mark.parametrize("dist", [(0, 6, 0), (6, 0, 0), (0, 0, 6)])
def test_detect_cs_64bit_two_cubes_above_2_32(dist, route):
    """``tests/test_kernels.py::test_detect_cs_64bit_two_cubes`` with the
    two cubes' ids above 2**32."""
    from test_kernels import CUBE_SIZE, STENCIL, _gen_two_cube_scene

    vol, exp_lo, exp_hi = _gen_two_cube_scene(np.array(dist), STENCIL, CUBE_SIZE)
    big = {4: 2**33 + 4, 5: 2**40 + 5}
    vol64 = np.zeros(vol.shape, np.uint64)
    for k, v in big.items():
        vol64[vol == k] = v
    want = np.stack([np.where(exp_lo > 0, np.uint64(big[4]), np.uint64(0)),
                     np.where(exp_hi > 0, np.uint64(big[5]), np.uint64(0))], axis=-1)
    got = tcontacts.detect_cs_64bit(vol64, stencil=STENCIL)
    ref = jcontacts.detect_cs_64bit(vol64, stencil=STENCIL)
    assert got.dtype == ref.dtype == np.uint64 and np.array_equal(got, ref)
    assert np.array_equal(got, want)


def test_detect_contact_partners_and_u64_boundaries(route):
    """A (3, 2) offset of (-half, +half) extents on a given boundary mask,
    ids above 2**32; the uint64 boundary mask (the native route above 4096
    voxels)."""
    rng = np.random.default_rng(5)
    vol = rng.integers(0, 5, (20, 18, 14)).astype(np.uint64)
    vol = np.where(vol > 0, vol * np.uint64(2**34) + np.uint64(3), np.uint64(0))
    bd_t, bd_j = tcontacts.detect_seg_boundaries(vol), jcontacts.detect_seg_boundaries(vol)
    assert np.array_equal(bd_t, bd_j) and bd_t.any()
    offset = np.array([[-2, 2], [-2, 2], [-1, 1]])
    got = tcontacts.detect_contact_partners(vol, bd_t, offset)
    ref = jcontacts.detect_contact_partners(vol, bd_j, offset)
    assert got.shape == (16, 14, 12, 2) and np.array_equal(got, ref) and got.any()
    assert np.array_equal(got, tcontacts.detect_cs_64bit(vol, stencil=(5, 5, 3)))


def test_detect_cs_reads_the_config_stencil(tmp_path):
    """``detect_cs(arr)`` takes ``cell_objects.cs_filtersize`` of the active
    working directory, as JAX's does."""
    from syconn_tpu.handler.config import generate_default_conf as jconf
    from syconn_tpu_torch.handler.config import generate_default_conf as tconf

    pairs = [("cell_objects", {"cs_filtersize": [7, 7, 3]})]
    wj, wt = str(tmp_path / "j"), str(tmp_path / "t")
    with jax_defaults_isolated():
        jconf(wj, scaling=(10, 10, 20), key_value_pairs=pairs)
    tconf(wt, scaling=(10, 10, 20), key_value_pairs=pairs)
    seg = np.random.default_rng(3).integers(0, 4, (18, 16, 10)).astype(np.uint32)
    with jax_wd(wj):
        ref = jcontacts.detect_cs(seg)
    with port_wd(wt):
        got = tcontacts.detect_cs(seg)
    assert got.shape == (12, 10, 8) and np.array_equal(got, ref) and got.any()
    assert np.array_equal(got, tcontacts.detect_cs(seg, stencil=(7, 7, 3)))


# ------------------------------------------------------------------- names
def _case_map_subcell_extract_props(tmp_path):
    from syconn_tpu.ops.props import map_subcell_extract_props as jf
    from syconn_tpu_torch.ops.props import map_subcell_extract_props as tf

    rng = np.random.default_rng(1)
    cell = rng.integers(0, 6, (16, 14, 10)).astype(np.uint64) * np.uint64(2**33)
    stack = rng.integers(0, 4, (2, 16, 14, 10)).astype(np.uint64)
    stack[1] *= np.uint64(7)
    _same(tf(cell, stack), jf(cell, stack))


def _case_proc_image(tmp_path):
    from syconn_tpu.proc import image as J
    from syconn_tpu_torch.proc import image as T

    rng = np.random.default_rng(2)
    img = rng.normal(size=(37, 29)).astype(np.float32) * 30
    _same(T.normalize_img(img), J.normalize_img(img))
    _same(T.normalize_img(np.ones((4, 4))), J.normalize_img(np.ones((4, 4))))
    u8 = rng.integers(0, 256, (37, 29)).astype(np.uint8)
    _same(T.clahe(u8), J.clahe(u8))
    _same(T.clahe(u8, clip_limit=4.0, tile=4), J.clahe(u8, clip_limit=4.0, tile=4))
    vol = rng.integers(0, 256, (20, 16, 5)).astype(np.uint8)
    for axis in (0, 2):
        _same(T.apply_clahe_slices(vol, axis=axis, tile=4),
              J.apply_clahe_slices(vol, axis=axis, tile=4))
    mask = np.zeros((12, 12, 8), bool)
    mask[2:10, 2:10, 1:7] = True
    mask[4:8, 4:8, 3:5] = False
    mask[0, 0, 0] = True
    _same(T.fill_voids(mask), J.fill_voids(mask))
    for coord in (None, (2, 2, 1), (0, 0, 0), (11, 11, 7)):
        _same(T.single_conn_comp(mask, coord), J.single_conn_comp(mask, coord))
    _same(T.single_conn_comp(np.zeros((3, 3, 3))), J.single_conn_comp(np.zeros((3, 3, 3))))
    pts = rng.uniform(-10, 10, (50, 3))
    _same(T.in_bounding_box(pts, ((1, 2, 0), (8, 6, 12))),
          J.in_bounding_box(pts, ((1, 2, 0), (8, 6, 12))))
    from syconn_tpu_torch.ops import morphology as tmorph

    for n in ("apply_morphological_operations", "get_aniso_struct", "multi_mop_backgroundonly"):
        assert getattr(T, n) is getattr(tmorph, n) and n in T.__all__
    assert sorted(T.__all__) == sorted(J.__all__)


def _object_mesh(package, wd, seg, obj_id):
    if package == "jax":
        from syconn_tpu.backend import VoxelStorageDyn
        from syconn_tpu.handler.config import generate_default_conf
        from syconn_tpu.io.chunked import ChunkedVolume
        from syconn_tpu.proc.meshes import get_object_mesh
        from syconn_tpu.reps.segmentation import SegmentationObject
    else:
        from syconn_tpu_torch.backend import VoxelStorageDyn
        from syconn_tpu_torch.handler.config import generate_default_conf
        from syconn_tpu_torch.io.chunked import ChunkedVolume
        from syconn_tpu_torch.proc.meshes import get_object_mesh
        from syconn_tpu_torch.reps.segmentation import SegmentationObject
    with jax_defaults_isolated():
        generate_default_conf(wd, scaling=(10, 10, 20))
    kd = os.path.join(wd, "seg")
    ChunkedVolume.create(kd, scale=(10, 10, 20), boundary=seg.shape).save_seg(seg)
    so = SegmentationObject(obj_id, "sv", working_dir=wd, scaling=(10, 10, 20), create=True)
    os.makedirs(os.path.dirname(so.voxel_path), exist_ok=True)
    vs = VoxelStorageDyn(so.voxel_path, read_only=False, voxeldata_path=kd)
    where = np.argwhere(seg == obj_id)
    vs.append_bounding_box(obj_id, [where.min(0), where.max(0) + 1])
    vs.increase_object_size(obj_id, len(where))
    vs.push()
    so = SegmentationObject(obj_id, "sv", working_dir=wd, scaling=(10, 10, 20))
    return get_object_mesh(so), get_object_mesh(so, downsampling=(2, 2, 1))


def _case_get_object_mesh(tmp_path):
    seg = np.zeros((24, 20, 12), np.uint64)
    seg[3:15, 4:16, 2:10] = 9
    seg[8:20, 6:12, 4:8] = 9
    seg[16:22, 14:19, 1:11] = 4
    j = _object_mesh("jax", str(tmp_path / "j"), seg, 9)
    t = _object_mesh("port", str(tmp_path / "t"), seg, 9)
    assert len(j[0][1]) > 0
    _same(t, j)


def _case_assign_rep_values(tmp_path):
    from syconn_tpu.reps.rep_helper import assign_rep_values as jf
    from syconn_tpu_torch.reps.rep_helper import assign_rep_values as tf

    rng = np.random.default_rng(4)
    tgt, rep = rng.uniform(0, 100, (200, 3)), rng.uniform(0, 100, (40, 3))
    vals = rng.integers(0, 5, 40)
    _same(tf(tgt, rep, vals), jf(tgt, rep, vals))
    _same(tf(tgt, rep, vals, nb_cpus=2), jf(tgt, rep, vals, nb_cpus=2))


def _zip_members(path):
    with zipfile.ZipFile(path) as zf:
        return [(i.filename, zf.read(i.filename)) for i in zf.infolist()]


def _case_handler_basics(tmp_path):
    from syconn_tpu.handler import basics as J
    from syconn_tpu_torch.handler import basics as T

    _same(T.flatten_list([[1, 2], [], [3], (4, 5)]), J.flatten_list([[1, 2], [], [3], (4, 5)]))
    src = tmp_path / "src"
    src.mkdir()
    for name, data in (("a.txt", b"alpha\n"), ("b.bin", bytes(range(256)) * 3),
                       ("c.txt", b"gamma")):
        (src / name).write_bytes(data)
    members = {}
    for tag, mod in (("j", J), ("t", T)):
        kz = str(tmp_path / tag / "cell.k.zip")
        mod.data2kzip(kz, [str(src / "a.txt"), str(src / "b.bin")])
        mod.data2kzip(kz, [str(src / "c.txt")], fnames_in_zip=["sub/c.txt"])
        full = _zip_members(kz)
        assert [mod.read_data_from_zip(kz, n) for n, _ in full] == [d for _, d in full]
        mod.remove_from_zip(kz, "b.bin")
        mod.data2kzip(kz, [str(src / "a.txt")], fnames_in_zip=["x.txt"], force_overwrite=True)
        members[tag] = (full, _zip_members(kz))
        assert os.listdir(tmp_path / tag) == ["cell.k.zip"]  # no temporary file left
    # zip members carry their write time: compare names and contents
    assert members["t"] == members["j"]
    assert [n for n, _ in members["t"][0]] == ["a.txt", "b.bin", "sub/c.txt"]
    assert members["t"][1] == [("x.txt", b"alpha\n")]
    for tag, mod in (("j", J), ("t", T)):
        dst = str(tmp_path / f"{tag}_copy.txt")
        mod.safe_copy(str(src / "a.txt"), dst)
        with pytest.raises(FileExistsError):
            mod.safe_copy(str(src / "c.txt"), dst)
        mod.safe_copy(str(src / "c.txt"), dst, safe=False)
        assert open(dst, "rb").read() == b"gamma"
    draws = {}
    for tag, mod in (("j", J), ("t", T)):
        np.random.seed(123)
        with mod.temp_seed(7):
            inner = np.random.rand(5)
        draws[tag] = (inner, np.random.rand(3))
    np.random.seed(123)
    _same(draws["t"], draws["j"])
    _same(draws["t"][1], np.random.rand(3))  # the outer state is restored


def _case_register_model(tmp_path):
    import jax

    from syconn_tpu.models import io as jio
    from syconn_tpu.models.unet3d import UNet3D as JUNet
    from syconn_tpu_torch.models import io as tio
    from syconn_tpu_torch.models.convert import flax_tree_from_module
    from syconn_tpu_torch.models.unet3d import UNet3D as TUNet

    kw = dict(features=(8, 16), strides=((2, 2, 2),), patch=(2, 2, 2), n_classes=2)

    class NamesTestUNet(JUNet):
        pass

    jm = NamesTestUNet(**kw)
    params = jm.init(jax.random.PRNGKey(3), np.zeros((1, 8, 8, 8, 1), np.float32))["params"]
    path = str(tmp_path / "names_test_unet")
    jio.save_model(path, jm, params)
    with pytest.raises(KeyError, match="Unknown model class"):
        tio.load_model(path)
    jio.register_model("NamesTestUNet")(NamesTestUNet)

    # the port's class of the same name (``save_model`` writes the class name)
    TNamesTestUNet = tio.register_model("NamesTestUNet")(type("NamesTestUNet", (TUNet,), {}))

    tm, tparams = tio.load_model(path)
    jm2, jparams = jio.load_model(path)
    assert type(tm) is TNamesTestUNet and type(jm2) is NamesTestUNet
    _same(jax.tree_util.tree_map(np.asarray, jparams), tparams)
    got = flax_tree_from_module(tm)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)), got, tparams))
    # a registered class round-trips through the port's save_model too
    tio.save_model(str(tmp_path / "again"), tm)
    assert type(tio.load_model(str(tmp_path / "again"))[0]) is TNamesTestUNet


def _case_step_cache(tmp_path):
    from syconn_tpu.handler.config import generate_default_conf as jconf
    from syconn_tpu.utils import stepcache as J
    from syconn_tpu_torch.handler.config import generate_default_conf as tconf
    from syconn_tpu_torch.utils import stepcache as T

    root = str(tmp_path / "root")
    assert T.step_cache_dir("s", root) == J.step_cache_dir("s", root)
    wj, wt = str(tmp_path / "j"), str(tmp_path / "t")
    with jax_defaults_isolated():
        jconf(wj, scaling=(10, 10, 20))
    tconf(wt, scaling=(10, 10, 20))
    with jax_wd(wj):
        jdir = J.step_cache_dir("scan")
        jc = J.StepCache("scan")
    with port_wd(wt):
        tdir = T.step_cache_dir("scan")
        tc = T.StepCache("scan")
    assert os.path.relpath(tdir, wt) == os.path.relpath(jdir, wj) == os.path.join(".stepcache",
                                                                                  "scan")
    assert (tc.dir, jc.dir) == (tdir, jdir)
    for c in (jc, tc):
        c.store("1_2", {"v": 3})
        c.mark_complete()
        assert c.done("1_2") and c.is_complete() and c.load("1_2") == {"v": 3}
        c.clear()
        assert not c.done("1_2") and not c.is_complete() and os.path.isdir(c.dir)
        assert os.listdir(c.dir) == []


def _case_aliases(tmp_path):
    import syconn_tpu_torch
    from syconn_tpu import backend as jbackend
    from syconn_tpu_torch import backend as tbackend
    from syconn_tpu_torch import parallel as tparallel
    from syconn_tpu_torch.backend import base as tbase
    from syconn_tpu_torch.backend import storage as tstorage
    from syconn_tpu_torch.handler import prediction as tpred
    from syconn_tpu_torch.inference import dense as tdense
    from syconn_tpu_torch.parallel import executor as texec

    assert tbackend.VoxelStorageL is tbackend.VoxelStorageClass is tstorage.VoxelStorage
    assert sorted(tbackend.__all__) == sorted(jbackend.__all__)
    assert tbase.FSBase is tbase.StorageBase
    with pytest.raises(NotImplementedError):
        tbase.BTBase()
    assert tpred.DenseTilePredictor is tdense.DenseTilePredictor
    assert tpred.predict_dense_to_kd is tdense.predict_dense_to_kd
    assert "DenseTilePredictor" in tpred.__all__
    for n in tparallel.__all__:
        assert getattr(tparallel, n) is getattr(texec, n)
    assert syconn_tpu_torch.global_params.config is not None


NAME_CASES = {
    "map_subcell_extract_props": _case_map_subcell_extract_props,
    "proc_image": _case_proc_image,
    "get_object_mesh": _case_get_object_mesh,
    "assign_rep_values": _case_assign_rep_values,
    "handler_basics": _case_handler_basics,
    "register_model": _case_register_model,
    "step_cache": _case_step_cache,
    "aliases": _case_aliases,
}


@pytest.mark.parametrize("case", sorted(NAME_CASES))
def test_name_equals_jax(case, tmp_path):
    NAME_CASES[case](tmp_path)
