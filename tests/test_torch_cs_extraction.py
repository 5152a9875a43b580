"""Step 6a as a whole: the port's ``extract_contact_sites`` against the JAX
package's on the two-cube world of tests/test_resident.py. Label volumes
and per-object tables hold integers (and ratios of integers): compared
exactly."""

import os

import numpy as np
import pytest

from _torch_helpers import compare_datasets, jax_defaults_isolated, port_wd

SH = (96, 64, 48)
CONF = [("syntype_avail", True), ("cell_objects", {"min_obj_vx": {"cs": 1, "syn": 1}}),
        ("tpu", {"shard_pipeline": False})]
CHUNK = (32, 64, 48)


def _world():
    seg = np.zeros(SH, np.uint64)
    seg[4:46, 4:60, 4:44] = 7
    seg[48:92, 4:60, 4:44] = 9
    sj = np.zeros(SH, np.uint8)
    sj[40:54, 20:40, 10:30] = 255
    return seg, {"sj": sj, "sym": sj * 0, "asym": sj}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's host path in a working directory: label volumes
    and the numpy data of its 'cs' and 'syn' datasets."""
    from syconn_tpu import global_params
    from syconn_tpu.extraction.cs_extraction import extract_contact_sites
    from syconn_tpu.handler.basics import clear_kd_cache
    from syconn_tpu.handler.config import generate_default_conf
    from syconn_tpu.io.chunked import ChunkedVolume
    from syconn_tpu.reps.segmentation import SegmentationDataset

    wd = str(tmp_path_factory.mktemp("jax_wd"))
    seg, maps = _world()
    clear_kd_cache()
    with jax_defaults_isolated():
        generate_default_conf(wd, scaling=(10, 10, 20), key_value_pairs=CONF,
                              force_overwrite=True)
    prev = global_params.wd
    global_params.wd = wd
    try:
        cfg = global_params.config
        ChunkedVolume.create(cfg.kd_seg_path, scale=(10, 10, 20), boundary=SH,
                             chunk_shape=(64, 64, 64)).save_seg(seg)
        for name, data in maps.items():
            ChunkedVolume.create(getattr(cfg, f"kd_{name}_path"), scale=(10, 10, 20),
                                 boundary=SH, chunk_shape=(64, 64, 64)).save_raw(data)
        counts = extract_contact_sites(chunk_shape=CHUNK)
        out = {"counts": counts, "wd": wd}
        for name in ("cs", "syn"):
            out[f"{name}_seg"] = ChunkedVolume.open(
                f"{cfg.working_dir}/knossosdatasets/{name}_seg").load_seg(size=SH)
            sd = SegmentationDataset(name, working_dir=wd)
            attrs = ["id", "size", "rep_coord", "bounding_box"]
            attrs += ["asym_prop", "sym_prop"] if name == "syn" else []
            out[name] = {a: sd.load_numpy_data(a) for a in attrs}
    finally:
        global_params.wd = prev
        clear_kd_cache()
    return out


def _port_world(root):
    from syconn_tpu_torch.io.chunked import ChunkedVolume

    seg, maps = _world()
    paths = {"seg": os.path.join(root, "seg")}
    ChunkedVolume.create(paths["seg"], scale=(10, 10, 20), boundary=SH,
                         chunk_shape=(64, 64, 64)).save_seg(seg)
    for name, data in maps.items():
        paths[name] = os.path.join(root, name)
        ChunkedVolume.create(paths[name], scale=(10, 10, 20), boundary=SH,
                             chunk_shape=(64, 64, 64)).save_raw(data)
    return seg, paths


def _port_run(paths, out_dir, **kw):
    from syconn_tpu_torch.exec.exec_syns import run_contact_extraction

    kw.setdefault("overwrite", True)
    return run_contact_extraction(
        paths["seg"], out_dir, kd_sj_path=paths["sj"], kd_sym_path=paths["sym"],
        kd_asym_path=paths["asym"], chunk_size=CHUNK, min_obj_vx={"cs": 1, "syn": 1},
        device="cpu", **kw)


def _check_against_jax(res, out_dir, jax_run):
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.ops.contacts import cs_pair_unpack

    assert {"n_cs": res["n_cs"], "n_syn": res["n_syn"]} == jax_run["counts"]
    assert res["n_cs"] > 0 and res["n_syn"] > 0
    vols = {}
    for name in ("cs", "syn"):
        vols[name] = ChunkedVolume.open(os.path.join(out_dir, f"{name}_seg")).load_seg(size=SH)
        assert np.array_equal(vols[name], jax_run[f"{name}_seg"]), name
        want, got = jax_run[name], res[name]
        assert np.array_equal(want["id"], got["ids"])
        assert np.array_equal(want["size"], got["sizes"])
        assert np.array_equal(want["rep_coord"].reshape(-1, 3), got["rep_coords"])
        assert np.array_equal(want["bounding_box"].reshape(-1, 2, 3), got["bounding_boxes"])
        lo, hi = cs_pair_unpack(got["ids"])
        assert np.array_equal(got["partner_ids"], np.stack([lo, hi], axis=1))
        assert set(got["partner_ids"].ravel().tolist()) == {7, 9}
    assert np.array_equal(jax_run["syn"]["asym_prop"], res["syn"]["asym_prop"])
    assert np.array_equal(jax_run["syn"]["sym_prop"], res["syn"]["sym_prop"])
    assert res["syn"]["asym_prop"].max() > 0
    # the syn voxel lists are the voxels of the syn label volume
    for oid, vox in zip(res["syn"]["ids"], res["syn"]["voxels"]):
        want = np.argwhere(vols["syn"] == oid)
        assert np.array_equal(want, vox[np.lexsort(vox.T[::-1])])


@pytest.mark.parametrize("kernel", ["auto", "cuda", "host"])
def test_streaming_extraction_matches_jax(tmp_path, jax_run, kernel):
    _, paths = _port_world(str(tmp_path))
    out_dir = str(tmp_path / "out")
    res = _port_run(paths, out_dir, kernel=kernel)
    _check_against_jax(res, out_dir, jax_run)
    st = res["stats"]
    assert st["path"] == ("host" if kernel == "host" else "stream") and st["chunks"] == 3
    assert st["dispatched"] == (0 if kernel == "host" else 3) and st["resumed"] == 0


def test_resident_extraction_matches_jax(tmp_path, jax_run):
    from syconn_tpu_torch.io import resident

    seg, paths = _port_world(str(tmp_path))
    out_dir = str(tmp_path / "out")
    resident.clear()
    try:
        assert resident.put(paths["seg"], "seg", seg, device="cpu")
        res = _port_run(paths, out_dir)
    finally:
        resident.clear()
    _check_against_jax(res, out_dir, jax_run)
    assert res["stats"]["path"] == "resident" and res["stats"]["dispatched"] == 3


def test_resume_with_overwrite_false(tmp_path, jax_run):
    """A rerun with ``overwrite=False`` loads finished chunks from the step
    cache, computes the missing one and merges to the same tables."""
    _, paths = _port_world(str(tmp_path))
    out_dir = str(tmp_path / "out")
    first = _port_run(paths, out_dir)
    cache_dir = os.path.join(out_dir, ".stepcache", "cs_extract")
    assert os.path.isfile(os.path.join(cache_dir, "__complete__"))
    os.remove(os.path.join(cache_dir, "1_0_0.pkl"))
    again = _port_run(paths, out_dir, overwrite=False)
    assert again["stats"]["resumed"] == 2 and again["stats"]["dispatched"] == 1
    _check_against_jax(again, out_dir, jax_run)
    for name in ("cs", "syn"):
        for k in ("ids", "sizes", "rep_coords", "bounding_boxes"):
            assert np.array_equal(first[name][k], again[name][k])
    full = _port_run(paths, out_dir, overwrite=False)
    assert full["stats"]["resumed"] == 3 and full["stats"]["path"] is None


def test_wide_ids_take_the_host_route_or_raise(tmp_path):
    """Chunks with ids >= 2**31 go through the host kernel; >= 2**32 raises."""
    from syconn_tpu_torch.extraction.cs_extraction import extract_contact_site_tables
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.ops.contacts import cs_pair_unpack

    seg, _ = _world()
    seg[seg == 9] = 2**31 + 5
    p = str(tmp_path / "seg")
    ChunkedVolume.create(p, scale=(10, 10, 20), boundary=SH, chunk_shape=(64, 64, 64)).save_seg(seg)
    res = extract_contact_site_tables(p, str(tmp_path / "out"), chunk_shape=CHUNK,
                                      min_obj_vx={"cs": 1}, device="cpu")
    assert res["stats"]["host_chunks"] == 2 and res["stats"]["dispatched"] == 1
    lo, hi = cs_pair_unpack(res["cs"]["ids"])
    assert lo.tolist() == [7] and hi.tolist() == [2**31 + 5] and res["n_syn"] == 0
    seg[seg == 7] = 2**32 + 1
    p2 = str(tmp_path / "seg2")
    ChunkedVolume.create(p2, scale=(10, 10, 20), boundary=SH, chunk_shape=(64, 64, 64)).save_seg(seg)
    with pytest.raises(ValueError, match="32-bit"):
        extract_contact_site_tables(p2, str(tmp_path / "out2"), chunk_shape=CHUNK, device="cpu")


@pytest.mark.parametrize("seg_resident", [False, True])
def test_config_driven_datasets_equal_jax(tmp_path, jax_run, seg_resident):
    """``run_syn_generation`` up to ``extract_contact_sites`` in a port
    working directory with the JAX run's configuration: the 'cs' and 'syn'
    datasets (numpy caches, per-shard attribute dicts, syn voxel lists) and
    label volumes equal the JAX package's, streaming and resident."""
    from syconn_tpu_torch.exec.exec_syns import run_syn_generation
    from syconn_tpu_torch.handler.config import generate_default_conf
    from syconn_tpu_torch.io import resident
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.reps.segmentation import SegmentationDataset

    wd = str(tmp_path / "wd")
    generate_default_conf(wd, scaling=(10, 10, 20), key_value_pairs=CONF)
    seg, maps = _world()
    resident.clear()
    try:
        with port_wd(wd) as cfg:
            ChunkedVolume.create(cfg.kd_seg_path, scale=(10, 10, 20), boundary=SH,
                                 chunk_shape=(64, 64, 64)).save_seg(seg)
            for name, data in maps.items():
                ChunkedVolume.create(getattr(cfg, f"kd_{name}_path"), scale=(10, 10, 20),
                                     boundary=SH, chunk_shape=(64, 64, 64)).save_raw(data)
            if seg_resident:
                assert resident.put(cfg.kd_seg_path, "seg", seg, device="cpu")
            with pytest.raises(NotImplementedError, match="Queue 1, item 7"):
                run_syn_generation(chunk_size=CHUNK, device="cpu")
            res = run_syn_generation(chunk_size=CHUNK, until="extract_contact_sites",
                                     device="cpu")
            sd = SegmentationDataset("syn")
            so = sd.get_segmentation_object(int(sd.ids[0]))
            assert so.lookup_in_attribute_dict("cs_id") == int(sd.ids[0])
    finally:
        resident.clear()
    assert {k: res[k] for k in ("n_cs", "n_syn")} == jax_run["counts"]
    assert res["stats"]["path"] == ("resident" if seg_resident else "stream")
    compare_datasets(jax_run["wd"], wd, ["cs", "syn"])
    for name in ("cs", "syn"):
        got = ChunkedVolume.open(os.path.join(wd, "knossosdatasets", f"{name}_seg"))
        assert np.array_equal(got.load_seg(size=SH), jax_run[f"{name}_seg"])
    assert os.path.isfile(os.path.join(wd, ".stepcache", "cs_extract", "__complete__"))
