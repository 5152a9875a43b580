"""The port's pipeline steps on logical CPU meshes against its serial path
and the JAX package's serial path (``tpu.shard_pipeline: false``; JAX's
own tests/test_sharded_pipeline.py holds its sharded path equal to it):

* ``from_probabilities_to_kd(mesh=)`` on the JAX test's slab volume (the
  erosion-seeded watershed across x-chunks), on a mesh that divides the
  x-chunks and one whose last slab pads past the volume, and resumed after a
  crash inside a slab: label volumes equal;
* step 2 through ``init_cell_subcell_sds`` with the meshes the config would
  give on a multi-card host (``map_subcell_extract_props(device_mesh=)``
  and the object extraction sharded): every dataset equal to JAX's;
* step 6a (``extract_contact_site_tables(mesh=)``, ``extract_contact_sites``):
  label volumes and tables equal to JAX's, the slab path's resume, ids of
  2**31 and above routed to the serial path;
* ``predict_dense_to_kd(mesh=)``: equal to the port's serial run, and to
  JAX's within tests/test_torch_dense.py's budget (2 LSB on >= 99.9%);
* ``ContextPredictor(mesh=)``: equal to the serial predictor at the
  replicas' batch; within 1e-5 of one forward of the whole batch (the
  CPU's matrix products round a 16-row head differently from a 2-row one,
  as JAX's own mesh test allows, tests/test_points_pipeline.py:148-149);
  argmax equal to JAX's serial predictor.
"""

import logging
import os

import numpy as np
import pytest
import torch

from _torch_helpers import compare_datasets, jax_defaults_isolated, port_wd
from syconn_tpu_torch.parallel.device import get_device_mesh

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _mesh(n, axis="sp"):
    return get_device_mesh(axis_names=(axis,), devices=[CPU] * n)


@pytest.fixture()
def jax_serial_wd(working_dir):
    """The JAX package's working directory on its single-device path."""
    from syconn_tpu import global_params
    from syconn_tpu.handler.config import generate_default_conf

    with jax_defaults_isolated():
        generate_default_conf(working_dir, scaling=(10, 10, 20),
                              key_value_pairs=[("tpu", {"shard_pipeline": False})],
                              force_overwrite=True)
    global_params.wd = working_dir
    yield working_dir


# ------------------------------------------------------------------ step 2


def _slab_volume(tmp_path):
    # tests/test_sharded_pipeline.py::test_object_extraction_sharded_identical
    from syconn_tpu.io.chunked import ChunkedVolume as JVolume
    from syconn_tpu_torch.io.chunked import ChunkedVolume as TVolume

    sh = (128, 32, 24)
    prob = np.zeros(sh, np.uint8)
    prob[4:60, 4:28, 4:20] = 255
    prob[60:124, 4:28, 4:20] = 255
    prob[58:62, :, :] = 200
    j, t = str(tmp_path / "j_prob"), str(tmp_path / "t_prob")
    JVolume.create(j, scale=(10, 10, 20), boundary=sh, chunk_shape=(16, 32, 32)).save_raw(prob)
    TVolume.create(t, scale=(10, 10, 20), boundary=sh, chunk_shape=(16, 32, 32)).save_raw(prob)
    kw = dict(thresh_uint8=128, morph_ops=["binary_erosion"] * 2, min_seed_vx=5,
              chunk_shape=(16, 32, 32))
    return sh, j, t, kw


@pytest.mark.parametrize("n_sp", [8, 3])
def test_object_extraction_sharded_equals_serial_and_jax(tmp_path, jax_serial_wd, n_sp):
    from syconn_tpu.extraction.object_extraction import from_probabilities_to_kd as jextract
    from syconn_tpu.io.chunked import ChunkedVolume as JVolume
    from syconn_tpu_torch.extraction import object_extraction as toe
    from syconn_tpu_torch.io.chunked import ChunkedVolume as TVolume

    sh, j, t, kw = _slab_volume(tmp_path)
    ref_stats = jextract(j, str(tmp_path / "j_seg"), mesh=None, **kw)
    ref = JVolume.open(str(tmp_path / "j_seg")).load_seg(size=sh)
    serial = toe.from_probabilities_to_kd(t, str(tmp_path / "t_serial"), device="cpu", **kw)
    stats = toe.from_probabilities_to_kd(t, str(tmp_path / "t_sharded"), device="cpu",
                                         mesh=_mesh(n_sp), **kw)
    assert serial["route"] == "device" and stats["route"] == "sharded"
    assert stats["n_objects"] == serial["n_objects"] == ref_stats["n_objects"] > 0
    got = TVolume.open(str(tmp_path / "t_sharded")).load_seg(size=sh)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, TVolume.open(str(tmp_path / "t_serial")).load_seg(size=sh))


def test_sharded_extraction_resumes_per_slab(tmp_path, monkeypatch, caplog):
    """A crash inside the second slab: the rerun loads the first slab from
    the step cache and recomputes the second whole; the volume equals an
    uninterrupted run."""
    from syconn_tpu_torch.extraction import object_extraction as toe
    from syconn_tpu_torch.io.chunked import ChunkedVolume as TVolume

    sh, _, t, kw = _slab_volume(tmp_path)
    mesh = _mesh(4)
    toe.from_probabilities_to_kd(t, str(tmp_path / "clean"), device="cpu", mesh=mesh, **kw)
    golden = TVolume.open(str(tmp_path / "clean")).load_seg(size=sh)
    real = toe.encode_chunk_labels
    calls = []

    def crash_at_six(*a, **k):
        calls.append(1)
        if len(calls) == 6:
            raise RuntimeError("injected crash")
        return real(*a, **k)

    monkeypatch.setattr(toe, "encode_chunk_labels", crash_at_six)
    with pytest.raises(RuntimeError, match="injected"):
        toe.from_probabilities_to_kd(t, str(tmp_path / "resumed"), device="cpu", mesh=mesh, **kw)
    monkeypatch.setattr(toe, "encode_chunk_labels", real)
    caplog.set_level(logging.INFO, logger="syconn_tpu_torch.extraction")
    stats = toe.from_probabilities_to_kd(t, str(tmp_path / "resumed"), device="cpu", mesh=mesh,
                                         overwrite=False, **kw)
    assert stats["resumed"] == 5
    assert any("resume: slab (0, 0, 0)" in r.message for r in caplog.records)
    assert np.array_equal(TVolume.open(str(tmp_path / "resumed")).load_seg(size=sh), golden)


def test_step2_sharded_datasets_equal_jax(tmp_path, monkeypatch):
    """Step 2 as a multi-card host runs it with ``tpu.shard_pipeline`` on
    (``mesh_from_config`` gives a two-position ``sp`` mesh): the organelle
    extraction and every property scan split over it, the datasets equal
    the JAX package's serial ones."""
    from syconn_tpu_torch.extraction import object_extraction as toe
    from syconn_tpu_torch.proc import sd_proc
    from test_torch_sd_proc import make_wd, run_jax_step2, run_port_step2, world

    mesh = _mesh(2)
    monkeypatch.setattr(toe, "mesh_from_config", lambda device=None: mesh)
    monkeypatch.setattr(sd_proc, "mesh_from_config", lambda device=None: mesh)
    seen = []
    real = sd_proc.object_properties_sharded
    monkeypatch.setattr(sd_proc, "object_properties_sharded",
                        lambda vol, m: seen.append(m) or real(vol, m))
    cell, probs, rag = world()
    wj, wt = str(tmp_path / "jax"), str(tmp_path / "port")
    with jax_defaults_isolated():
        make_wd(wj, "jax", cell, probs, rag)
    make_wd(wt, "port", cell, probs, rag, conf=[("min_cc_size_ssv", 450)])
    cj, _ = run_jax_step2(wj)
    ct, _ = run_port_step2(wt)
    assert {k: v for k, v in ct.items() if k != "stats"} == cj
    assert ct["stats"]["scan"]["cell_route"] == "sharded" and seen and seen[0] is mesh
    assert {ct["stats"]["extraction"][co]["route"] for co in ("mi", "vc")} == {"sharded"}
    compare_datasets(wj, wt, ["sv", "mi", "vc"])


# ----------------------------------------------------------------- step 6a


from test_torch_cs_extraction import (CHUNK, SH, _check_against_jax, _port_run,  # noqa: E402
                                      _port_world, _world, jax_run)

assert jax_run  # a fixture of this module too


def test_contact_tables_sharded_equal_jax(tmp_path, jax_run):
    """Three x-chunks over a two-position mesh: one slab and one padded
    past the volume; then a rerun without one chunk of the first slab in
    the step cache recomputes that slab whole."""
    _, paths = _port_world(str(tmp_path))
    out_dir = str(tmp_path / "out")
    res = _port_run(paths, out_dir, mesh=_mesh(2))
    _check_against_jax(res, out_dir, jax_run)
    st = res["stats"]
    assert st["path"] == "sharded" and st["slabs"] == 2 and st["dispatched"] == 4
    os.remove(os.path.join(out_dir, ".stepcache", "cs_extract", "1_0_0.pkl"))
    again = _port_run(paths, out_dir, mesh=_mesh(2), overwrite=False)
    assert again["stats"]["resumed"] == 1 and again["stats"]["slabs"] == 1
    _check_against_jax(again, out_dir, jax_run)


def test_contact_slab_with_wide_ids_takes_the_serial_path(tmp_path):
    """A slab holding ids of 2**31 and above goes on to the serial paths
    (the host kernel there); the result equals the serial run."""
    from syconn_tpu_torch.extraction.cs_extraction import extract_contact_site_tables
    from syconn_tpu_torch.io.chunked import ChunkedVolume

    seg, _ = _world()
    seg[seg == 9] = 2**31 + 5
    p = str(tmp_path / "seg")
    ChunkedVolume.create(p, scale=(10, 10, 20), boundary=SH, chunk_shape=(64, 64, 64)).save_seg(seg)
    kw = dict(chunk_shape=CHUNK, min_obj_vx={"cs": 1}, device="cpu")
    ref = extract_contact_site_tables(p, str(tmp_path / "serial"), **kw)
    res = extract_contact_site_tables(p, str(tmp_path / "out"), mesh=_mesh(3), **kw)
    assert res["stats"]["slabs"] == 0 and res["stats"]["host_chunks"] == 2
    for k in ("ids", "sizes", "rep_coords", "bounding_boxes"):
        assert np.array_equal(res["cs"][k], ref["cs"][k])


def test_extract_contact_sites_with_a_mesh_equals_jax(tmp_path, jax_run):
    """The config-driven step 6a with ``mesh=``: datasets and label volumes
    equal the JAX package's."""
    from syconn_tpu_torch.extraction.cs_extraction import extract_contact_sites
    from syconn_tpu_torch.handler.config import generate_default_conf
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from test_torch_cs_extraction import CONF

    wd = str(tmp_path / "wd")
    generate_default_conf(wd, scaling=(10, 10, 20), key_value_pairs=CONF)
    seg, maps = _world()
    with port_wd(wd) as cfg:
        ChunkedVolume.create(cfg.kd_seg_path, scale=(10, 10, 20), boundary=SH,
                             chunk_shape=(64, 64, 64)).save_seg(seg)
        for name, data in maps.items():
            ChunkedVolume.create(getattr(cfg, f"kd_{name}_path"), scale=(10, 10, 20),
                                 boundary=SH, chunk_shape=(64, 64, 64)).save_raw(data)
        res = extract_contact_sites(chunk_shape=CHUNK, mesh=_mesh(2), device="cpu")
    assert {k: res[k] for k in ("n_cs", "n_syn")} == jax_run["counts"]
    assert res["stats"]["path"] == "sharded"
    compare_datasets(jax_run["wd"], wd, ["cs", "syn"])
    for name in ("cs", "syn"):
        got = ChunkedVolume.open(os.path.join(wd, "knossosdatasets", f"{name}_seg"))
        assert np.array_equal(got.load_seg(size=SH), jax_run[f"{name}_seg"])


# ------------------------------------------------------------- inference


def test_dense_prediction_data_sharded(tmp_path):
    """tests/test_sharded_pipeline.py::test_dense_prediction_data_sharded_identical
    on the port: a ``data`` mesh of 4 (batch 1 rounded up to 4) equals the
    serial run; against JAX's serial run within the dense budget."""
    import jax

    from syconn_tpu.inference import dense as jdense
    from syconn_tpu.io.chunked import ChunkedVolume as JVolume
    from syconn_tpu.models.io import init_model_params
    from syconn_tpu.models.unet3d import UNet3D as JU
    from syconn_tpu_torch.inference import dense as tdense
    from syconn_tpu_torch.io.chunked import ChunkedVolume as TVolume
    from syconn_tpu_torch.models.unet3d import UNet3D as TU

    rng = np.random.default_rng(0)
    vol = rng.integers(0, 255, (64, 64, 32), dtype=np.uint8)
    j, t = str(tmp_path / "j_src"), str(tmp_path / "t_src")
    for vc, path in ((JVolume, j), (TVolume, t)):
        vc.create(path, scale=(10, 10, 20), boundary=vol.shape,
                  chunk_shape=(32, 32, 32)).save_raw(vol)
    kw = dict(features=(16, 32), strides=((2, 2, 2),), patch=(2, 2, 2), n_classes=3)
    jm = JU(**kw)
    jparams = init_model_params(jm, (1, 32, 32, 32, 1))
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jparams)
    tile = dict(tile_shape=(32, 32, 32), halo=(8, 8, 8))
    jdense.predict_dense_to_kd(j, {"a": str(tmp_path / "j_a")}, jm, jparams, {"a": 1},
                               predictor=jdense.DenseTilePredictor(jm, jparams, **tile),
                               target_mags=(1,), show_progress=False, **tile)
    tm = TU(**kw)
    ser = tdense.predict_dense_to_kd(t, {"a": str(tmp_path / "t_serial")}, tm, params, {"a": 1},
                                     target_mags=(1,), device="cpu", show_progress=False, **tile)
    mesh = _mesh(4, "data")
    sh = tdense.predict_dense_to_kd(t, {"a": str(tmp_path / "t_sharded")}, tm, params, {"a": 1},
                                    target_mags=(1,), device="cpu", show_progress=False,
                                    mesh=mesh, **tile)
    assert ser["dispatches"] == 5 and sh["dispatches"] == 2  # probe + 4 tiles / + 1 batch
    a = TVolume.open(str(tmp_path / "t_serial")).load_raw(size=vol.shape)
    b = TVolume.open(str(tmp_path / "t_sharded")).load_raw(size=vol.shape)
    assert np.array_equal(a, b) and int(a.max()) > int(a.min())
    ref = JVolume.open(str(tmp_path / "j_a")).load_raw(size=vol.shape)
    d = np.abs(b.astype(np.int16) - ref.astype(np.int16))
    assert np.mean(d <= 2) >= 0.999, (float(np.mean(d <= 2)), int(d.max()))
    # predictor level: the batch splits over the mesh, equal to per-tile serial
    pred_m = tdense.DenseTilePredictor(tm, params, device="cpu", mesh=mesh, **tile)
    assert pred_m.batch_size == 4
    tiles = rng.integers(0, 255, (4, 48, 48, 48), dtype=np.uint8)
    pred_s = tdense.DenseTilePredictor(tm, params, device="cpu", **tile)
    out_s = np.concatenate([pred_s.predict_tiles(tiles[i:i + 1]) for i in range(4)])
    assert np.array_equal(pred_m.predict_tiles(tiles), out_s)
    res = tdense.ResidentDensePredictor(tm, params, device="cpu", mesh=_mesh(2, "data"),
                                        tile_batch=3, **tile)
    assert res.tile_batch == 4
    packed, grid = res.predict_volume_packed(vol)
    assert grid == (2, 2, 1) and packed.shape[0] == 4 and res.n_forward == 1


@pytest.mark.parametrize("batch", [16, 10])
def test_context_predictor_data_sharded(batch):
    """tests/test_points_pipeline.py::test_context_predictor_mesh_* on the
    port (tolerances: module docstring)."""
    import jax

    from syconn_tpu.inference.points import ContextPredictor as JPred
    from syconn_tpu.models.io import init_model_params
    from syconn_tpu.models.pointnet import PointClassNet as JNet
    from syconn_tpu_torch.inference.points import ContextPipeline, ContextPredictor
    from syconn_tpu_torch.models.convert import module_state_from_flax
    from syconn_tpu_torch.models.pointnet import PointClassNet as TNet

    npoints = 128
    jnet = JNet(n_classes=8, widths=(16, 32), k=4)
    params = init_model_params(jnet, (1, npoints, 7))
    tnet = TNet(n_classes=8, widths=(16, 32), k=4)
    tnet.load_state_dict(module_state_from_flax(
        jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params)))
    rng = np.random.default_rng(7)
    items = list(range(24))
    ctx_of = {i: rng.normal(size=(int(rng.integers(2, 6)), npoints, 7)).astype(np.float32)
              for i in items}

    def run(pred):
        got = {}

        def post(i, out, aux):
            got[i] = out["logits"]
            return 1

        assert sum(ContextPipeline(pred, n_loaders=2, n_writers=2).run(
            items, lambda i: (ctx_of[i], None), post)) == len(items)
        return got

    mesh = _mesh(8, "data")
    pred_m = ContextPredictor(tnet, npoints=npoints, batch=batch, device="cpu", mesh=mesh)
    assert pred_m.batch == 16  # rounded up to a multiple of 8
    assert pred_m.dispatch(np.zeros((3, npoints, 7), np.float32))["logits"].shape[0] == 16
    sharded = run(pred_m)
    whole = run(ContextPredictor(tnet, npoints=npoints, batch=16, device="cpu"))
    jgot = run(JPred(jnet, params, npoints=npoints, batch=16))
    # the replicas' work, serially: 16-row batches as eight 2-row forwards
    serial2 = ContextPredictor(tnet, npoints=npoints, batch=2, device="cpu")
    for i in items:
        np.testing.assert_allclose(sharded[i], whole[i], rtol=1e-5, atol=1e-5)
        assert np.array_equal(sharded[i].argmax(-1), np.asarray(jgot[i]).argmax(-1))
    rows = np.concatenate([ctx_of[i] for i in items])[:16]
    one = pred_m.fetch(pred_m.dispatch(rows))["logits"]
    two = np.concatenate([serial2.fetch(serial2.dispatch(rows[k:k + 2]))["logits"]
                          for k in range(0, 16, 2)])
    assert np.array_equal(one, two)
