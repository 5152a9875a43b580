"""The port's device property scans (``ops/props_torch.py``) and the fused
SD property scan (``proc/sd_proc.py``) against the JAX package on the CPU.

Every comparison is exact (``array_equal``): the raw padded tables (the
overflow folding into the last row included), the host wrappers and their
overflow raises, the resident scanner with its table growth, and the scan's
tables and mapping counts against what the JAX package's
``map_subcell_extract_props`` writes into its ``SegmentationDataset``s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syconn_tpu.ops import props_jax as J
from syconn_tpu.ops.props import object_properties_arrays, pair_counts
from syconn_tpu_torch.ops import props_torch as T


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU: torch's
    default of one thread per core in every process oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_object_properties_match_host_and_jax(rng):
    vol = rng.integers(0, 50, size=(32, 24, 16)).astype(np.uint32)
    host = object_properties_arrays(vol)
    ref = J.object_properties_tpu(vol, max_ids=128)
    got = T.object_properties_torch(vol, max_ids=128, device="cpu")
    for g, h, r in zip(got, host, ref):
        assert g.dtype == r.dtype and np.array_equal(g, h) and np.array_equal(g, r)


@pytest.mark.parametrize("max_ids", [64, 1024])
def test_device_tables_match_jax_including_overflow(max_ids):
    vol = np.arange(1, 1001, dtype=np.int32).reshape(10, 10, 10)  # 1000 labels
    ref = J.object_properties_device(jnp.asarray(vol), max_ids)
    got = T.object_properties_device(torch.from_numpy(vol), max_ids)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    assert int(got[4]) == 1000


def test_object_properties_overflow_raises():
    vol = np.arange(1, 1001, dtype=np.uint32).reshape(10, 10, 10)
    with pytest.raises(ValueError, match="max_ids"):
        T.object_properties_torch(vol, max_ids=64, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        T.object_properties_torch(np.full((2, 2, 2), 2**31, np.uint64), device="cpu")


@pytest.mark.parametrize("max_pairs", [8, 128])
def test_pair_counts_match_host_and_jax(rng, max_pairs):
    a = rng.integers(0, 6, size=(16, 16, 8)).astype(np.int32)
    b = rng.integers(0, 6, size=(16, 16, 8)).astype(np.int32)
    ref = J.pair_counts_device(jnp.asarray(a), jnp.asarray(b), max_pairs)
    got = T.pair_counts_device(torch.from_numpy(a), torch.from_numpy(b), max_pairs)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    if max_pairs == 128:
        ah, bh, ch = pair_counts(a.astype(np.uint32), b.astype(np.uint32))
        ad, bd, cd = T.pair_counts_torch(a.astype(np.uint32), b.astype(np.uint32),
                                         max_pairs=max_pairs, device="cpu")
        assert sorted(zip(ad.tolist(), bd.tolist(), cd.tolist())) == \
            sorted(zip(ah.tolist(), bh.tolist(), ch.tolist()))
        assert cd.dtype == np.int64
    else:
        # 25 unique (a, b) pairs > 8 must raise, not merge
        with pytest.raises(ValueError, match="max_pairs"):
            T.pair_counts_torch(a, b, max_pairs=max_pairs, device="cpu")


def test_resident_props_scanner_matches_host_and_jax():
    """tests/test_resident.py::test_resident_props_scanner_identical."""
    rng = np.random.default_rng(7)
    sh = (70, 48, 40)  # not a chunk multiple -> boundary windows
    vol = rng.integers(0, 50, sh).astype(np.uint32)
    jscan = J.ResidentPropsScanner(jnp.asarray(vol.astype(np.int32)), chunk=(32, 32, 32))
    tscan = T.ResidentPropsScanner(torch.from_numpy(vol.astype(np.int32)), chunk=(32, 32, 32))
    for cix in [(0, 0, 0), (1, 0, 0), (2, 1, 1)]:
        off = np.array(cix) * 32
        size = np.minimum(32, np.array(sh) - off)
        chunk = vol[off[0]:off[0] + size[0], off[1]:off[1] + size[1], off[2]:off[2] + size[2]]
        host = object_properties_arrays(chunk)
        got = tscan.props(cix)
        assert got[0].dtype == np.uint64
        for g, h, r in zip(got, host, jscan.props(cix)):
            assert np.array_equal(g, h.astype(g.dtype)) and np.array_equal(g, r)
    # dense labels: > 4096 ids in one chunk take the growth path
    dense = (np.arange(32 * 32 * 32, dtype=np.uint32).reshape(32, 32, 32) // 4) + 1
    big = np.zeros((64, 32, 32), np.uint32)
    big[:32] = dense
    got = T.ResidentPropsScanner(torch.from_numpy(big.astype(np.int32)),
                                 chunk=(32, 32, 32)).props((0, 0, 0))
    assert len(got[0]) == 8192 > 4096
    for g, h in zip(got, object_properties_arrays(dense)):
        assert np.array_equal(g, h.astype(g.dtype))


def _world(cfg):
    """tests/test_sd_proc.py's cell + mi world, plus a vc volume."""
    from syconn_tpu.io.chunked import ChunkedVolume

    sh = (64, 64, 32)
    cell = np.zeros(sh, np.uint64)
    cell[4:30, 4:60, 4:28] = 10
    cell[34:60, 4:60, 4:28] = 22
    mi = np.zeros(sh, np.uint64)
    mi[10:20, 10:20, 10:20] = 1
    mi[36:44, 10:20, 10:20] = 2
    mi[28:38, 30:40, 10:20] = 3  # straddles both cells
    mi[50:54, 50:54, 2:6] = 4  # under min_obj_vx
    vc = np.zeros(sh, np.uint64)
    vc[20:26, 40:50, 4:12] = 5
    vc[40:48, 44:52, 20:30] = 6
    paths = {"sv": cfg.kd_seg_path, "mi": cfg.kd_organelle_seg_paths["mi"],
             "vc": cfg.kd_organelle_seg_paths["vc"]}
    for name, data in (("sv", cell), ("mi", mi), ("vc", vc)):
        ChunkedVolume.create(paths[name], scale=(10, 10, 20), boundary=sh,
                             chunk_shape=(32, 32, 32)).save_seg(data)
    return sh, {"sv": cell, "mi": mi, "vc": vc}


@pytest.mark.parametrize("cell_resident", [False, True])
def test_scan_tables_match_jax_datasets(tmp_path, working_dir, cell_resident):
    from syconn_tpu import global_params
    from syconn_tpu.handler.basics import clear_kd_cache
    from syconn_tpu.proc.sd_proc import map_subcell_extract_props
    from syconn_tpu.reps.segmentation import SegmentationDataset
    from syconn_tpu_torch import global_params as tparams
    from syconn_tpu_torch.io import resident
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.proc.sd_proc import map_subcell_extract_props_tables

    clear_kd_cache()
    cfg = global_params.config
    sh, vols = _world(cfg)
    counts = map_subcell_extract_props(cfg.kd_seg_path, {co: cfg.kd_organelle_seg_paths[co]
                                                         for co in ("mi", "vc")},
                                       chunk_shape=(32, 32, 32))
    paths = {}
    for name, data in vols.items():
        paths[name] = str(tmp_path / f"t_{name}")
        ChunkedVolume.create(paths[name], scale=(10, 10, 20), boundary=sh,
                             chunk_shape=(32, 32, 32)).save_seg(data)
    resident.clear()
    try:
        if cell_resident:
            assert resident.put(paths["sv"], "seg", vols["sv"], device="cpu")
        res = map_subcell_extract_props_tables(
            paths["sv"], {"mi": paths["mi"], "vc": paths["vc"]}, chunk_shape=(32, 32, 32),
            min_obj_vx=tparams.config["cell_objects"]["min_obj_vx"], device="cpu")
    finally:
        resident.clear()
    assert res["stats"]["cell_route"] == ("resident" if cell_resident else "host")
    assert res["counts"] == counts
    for t in ("sv", "mi", "vc"):
        sd = SegmentationDataset(t, working_dir=working_dir)
        ids, rep, bb, sz = res["tables"][t]
        assert np.array_equal(ids, sd.load_numpy_data("id"))
        assert np.array_equal(sz, sd.load_numpy_data("size"))
        assert np.array_equal(rep, sd.load_numpy_data("rep_coord"))
        assert np.array_equal(bb, sd.load_numpy_data("bounding_box"))
        for k, oid in enumerate(ids.tolist()):
            so = sd.get_segmentation_object(oid)
            so.load_attr_dict()
            ad = so.attr_dict
            if t != "sv":
                cc = res["mapping"][t].get(oid, {})
                m_ids = sorted(cc)
                assert ad["mapping_ids"].tolist() == m_ids
                assert np.array_equal(ad["mapping_ratios"],
                                      np.array([cc[i] for i in m_ids], np.float64) / sz[k])
                continue
            for co in ("mi", "vc"):
                entries = sorted((sc, cnts[oid]) for sc, cnts in res["mapping"][co].items()
                                 if oid in cnts)
                assert ad[f"mapping_{co}_ids"].tolist() == [e[0] for e in entries]
                assert np.array_equal(ad[f"mapping_{co}_ratios"], np.array(
                    [c / res["sc_sizes"][co][sc] for sc, c in entries], np.float64))
    assert 4 in res["sc_sizes"]["mi"] and 4 not in res["tables"]["mi"][0].tolist()
