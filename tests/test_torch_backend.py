"""The port's stores (``backend/``), locking and storage layout
(``reps/rep_helper.py``) against the JAX package, on the inputs of
tests/test_backend.py and tests/test_rep_helper.py: push-and-reopen for
every store class, each package reading the other's zstd stores, the port's
zlib fallback, and the shard layout. All comparisons are exact."""

import os
import subprocess
import sys

import numpy as np
import pytest

import syconn_tpu.backend as jb
import syconn_tpu.reps.rep_helper as jr
import syconn_tpu_torch.backend as tb
import syconn_tpu_torch.reps.rep_helper as tr
from syconn_tpu_torch.backend.base import compress_payload, decompress_payload
from syconn_tpu_torch.utils.locking import InterProcessLock, LockTimeout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(0)
SKEL = {"nodes": np.array([[0, 0, 0], [1, 1, 1]], np.float32),
        "edges": np.array([[0, 1]], np.int64), "diameters": np.array([1.0, 2.0], np.float32)}
MASK = np.zeros((4, 4, 4), bool)
MASK[1:3, 1:3, 1:3] = True


def _fill(mod, cls, path):
    """tests/test_backend.py's contents for one store class."""
    if cls == "AttributeDict":
        s = mod.AttributeDict(path, read_only=False)
        s[1] = {"size": 10, "rep_coord": [1, 2, 3]}
        s[2]["foo"] = "bar"  # auto-vivified entry
    elif cls == "CompressedStorage":
        s = mod.CompressedStorage(path, read_only=False)
        s[7] = np.random.default_rng(0).normal(size=(17, 5)).astype(np.float32)
        s[(8, "raw")] = np.arange(40, dtype=np.uint64).reshape(2, 4, 5)
    elif cls == "VoxelStorage":
        s = mod.VoxelStorage(path, read_only=False)
        s.append(5, MASK, (10, 10, 10))
        s.append(5, MASK, (20, 20, 20))
    elif cls == "VoxelStorageDyn":
        s = mod.VoxelStorageDyn(path, read_only=False, voxeldata_path="/some/seg")
        s.append_bounding_box(3, np.array([[1, 2, 3], [4, 5, 6]]))
        s.append_bounding_box(3, np.array([[0, 4, 3], [2, 9, 6]]))
        s.increase_object_size(3, 12)
        s.increase_object_size(3, 30)
        s.set_object_attrs(3, extra=7)
    elif cls == "VoxelStorageLazyLoading":
        s = mod.VoxelStorageLazyLoading(path)
        s[10] = np.arange(90).reshape((30, 3))
        s[11] = np.zeros((0, 3), np.int64)
    elif cls == "MeshStorage":
        s = mod.MeshStorage(path, read_only=False)
        s[3] = [np.arange(9, dtype=np.int64),
                np.random.default_rng(1).normal(size=(9,)).astype(np.float32),
                np.zeros(0, np.float32)]
        s[4] = [np.arange(3), np.ones(9, np.float32), np.ones(9, np.float32),
                np.full(12, 255, np.uint8)]
    elif cls == "SkeletonStorage":
        s = mod.SkeletonStorage(path, read_only=False)
        s[9] = SKEL
    s.push()


def _check(mod, cls, path):
    if cls == "AttributeDict":
        s = mod.AttributeDict(path, read_only=True)
        assert s[1] == {"size": 10, "rep_coord": [1, 2, 3]} and s[2] == {"foo": "bar"}
        assert 3 not in s and len(s) == 2
    elif cls == "CompressedStorage":
        s = mod.CompressedStorage(path, read_only=True)
        ref = np.random.default_rng(0).normal(size=(17, 5)).astype(np.float32)
        assert s[7].dtype == np.float32 and np.array_equal(s[7], ref)
        assert np.array_equal(s[(8, "raw")], np.arange(40, dtype=np.uint64).reshape(2, 4, 5))
    elif cls == "VoxelStorage":
        s = mod.VoxelStorage(path, read_only=True)
        masks, offsets = s[5]
        assert len(masks) == 2 and np.array_equal(masks[0], MASK)
        assert np.array_equal(offsets[1], [20, 20, 20]) and s.object_size(5) == 16
    elif cls == "VoxelStorageDyn":
        s = mod.VoxelStorageDyn(path, read_only=True)
        assert list(s.keys()) == [3] and s.object_size(3) == 42
        assert np.array_equal(s.object_bounding_box(3), [[0, 2, 3], [4, 9, 6]])
        assert s.get_object_attr(3, "extra") == 7 and s._voxeldata_path == "/some/seg"
    elif cls == "VoxelStorageLazyLoading":
        s = mod.VoxelStorageLazyLoading(path)
        assert sorted(s.keys()) == [10, 11] and len(s) == 2
        assert np.array_equal(s[10], np.arange(90).reshape((30, 3))) and s[11].shape == (0, 3)
    elif cls == "MeshStorage":
        s = mod.MeshStorage(path, read_only=True)
        assert np.array_equal(s[3][0], np.arange(9))
        assert np.array_equal(s[3][1], np.random.default_rng(1).normal(size=(9,)).astype(np.float32))
        assert len(s[4]) == 4 and np.array_equal(s[4][3], np.full(12, 255, np.uint8))
    elif cls == "SkeletonStorage":
        got = mod.SkeletonStorage(path, read_only=True)[9]
        assert all(np.array_equal(got[k], SKEL[k]) and got[k].dtype == SKEL[k].dtype for k in SKEL)


CLASSES = ["AttributeDict", "CompressedStorage", "VoxelStorage", "VoxelStorageDyn",
           "VoxelStorageLazyLoading", "MeshStorage", "SkeletonStorage"]


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("cls", CLASSES)
def test_store_push_reopen_across_packages(tmp_path, cls, writer, reader):
    mods = {"port": tb, "jax": jb}
    path = str(tmp_path / ("s.npz" if cls == "VoxelStorageLazyLoading" else "s.pkl"))
    _fill(mods[writer], cls, path)
    _check(mods[reader], cls, path)


def test_payload_codec_by_magic_bytes():
    """zstd frames begin 28 B5 2F FD, zlib streams 0x78: the port reads both
    and refuses anything else."""
    import zlib

    arr = np.arange(1000, dtype=np.int32).reshape(10, 100)
    buf, dtype, shape = compress_payload(arr)
    assert buf[:4] == b"\x28\xb5\x2f\xfd"  # zstandard imports here
    zl = (zlib.compress(arr.tobytes(), 3), dtype, shape)
    assert zl[0][:1] == b"\x78"
    for payload in ((buf, dtype, shape), zl):
        assert np.array_equal(decompress_payload(payload), arr)
    with pytest.raises(ValueError, match="neither zstd nor zlib"):
        decompress_payload((b"\x00\x01junk", dtype, shape))


_ZLIB_WRITER = r"""
import sys
sys.modules["zstandard"] = None
sys.path.insert(0, {root!r})
import numpy as np
import syconn_tpu_torch.backend as tb
s = tb.CompressedStorage({path!r}, read_only=False)
s[1] = np.arange(64, dtype=np.uint64).reshape(4, 16)
s.push()
m = tb.MeshStorage({path!r} + ".mesh", read_only=False)
m[2] = [np.arange(6), np.ones(6, np.float32), np.zeros(0, np.float32)]
m.push()
r = tb.CompressedStorage({path!r}, read_only=True)
assert r._dc_intern[1][0][:1] == b"\x78"
assert np.array_equal(r[1], np.arange(64, dtype=np.uint64).reshape(4, 16))
assert np.array_equal(tb.MeshStorage({path!r} + ".mesh", read_only=True)[2][0], np.arange(6))
print("ok")
"""


def test_zlib_store_without_zstandard(tmp_path):
    """With ``zstandard`` blocked the port writes zlib payloads and reads
    them back; with it, the port still reads them (by their first bytes).
    The JAX package cannot (ROADMAP Queue 3, item 2)."""
    path = str(tmp_path / "z.pkl")
    out = subprocess.run([sys.executable, "-c", _ZLIB_WRITER.format(root=ROOT, path=path)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert np.array_equal(tb.CompressedStorage(path)[1], np.arange(64, dtype=np.uint64).reshape(4, 16))
    import zstandard

    with pytest.raises(zstandard.ZstdError):
        jb.CompressedStorage(path)[1]


def test_read_only_and_locking(tmp_path):
    p = str(tmp_path / "ro.pkl")
    cs = tb.CompressedStorage(p, read_only=False)
    cs[1] = np.zeros(3)
    cs.push()
    with pytest.raises(RuntimeError):
        tb.CompressedStorage(p, read_only=True)[2] = np.ones(3)
    w = tb.AttributeDict(p + ".ad", read_only=False, timeout=0.2)  # holds the write lock
    with pytest.raises(LockTimeout):
        tb.AttributeDict(p + ".ad", read_only=False, timeout=0.2)
    w.push()  # releases it
    tb.AttributeDict(p + ".ad", read_only=False, timeout=0.2).push()
    lk = InterProcessLock(str(tmp_path / ".x.lk"))
    with lk:
        assert not InterProcessLock(lk.path).acquire(timeout=0.1)
    assert InterProcessLock(lk.path).acquire(timeout=0.1)


@pytest.mark.parametrize("n_folders", [10, 100, 1000, 10000])
def test_subfolders_equal_jax(n_folders):
    ids = np.concatenate([np.arange(0, 5000, 7), RNG.integers(0, 2**40, 500)]).tolist()
    for ix in ids:
        assert tr.subfold_from_ix_new(ix, n_folders) == jr.subfold_from_ix_new(ix, n_folders)
        for old in (False, True):
            assert tr.subfold_from_ix_OLD(ix, n_folders, old) == \
                jr.subfold_from_ix_OLD(ix, n_folders, old)
        assert tr.subfold_from_ix(ix, n_folders) == jr.subfold_from_ix(ix, n_folders)
    reps = tr.get_unique_subfold_ixs(n_folders)
    assert np.array_equal(reps, jr.get_unique_subfold_ixs(n_folders))
    for rep in reps.tolist():
        sf = tr.subfold_from_ix_new(rep, n_folders)
        assert tr.ix_from_subfold_new(sf, n_folders) == jr.ix_from_subfold_new(sf, n_folders) == rep
        assert tr.ix_from_subfold(sf, n_folders) == rep
        old = tr.subfold_from_ix_OLD(rep, n_folders)
        assert tr.ix_from_subfold_OLD(old, n_folders) == jr.ix_from_subfold_OLD(old, n_folders)
    assert len({tr.subfold_from_ix_new(i, n_folders) for i in range(0, 1000 * n_folders, 1000)}) \
        == n_folders


def test_surface_samples_equal_jax():
    coords = RNG.normal(size=(5000, 3)) * 4000
    for kw in ({}, {"bin_sizes": (500, 500, 500), "max_nb_samples": 100}):
        assert np.array_equal(tr.surface_samples(coords, **kw), jr.surface_samples(coords, **kw))
