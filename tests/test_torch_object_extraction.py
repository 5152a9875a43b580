"""The port's object extraction (``extraction/object_extraction.py``,
``exec/exec_init.py``) against the JAX package's ``from_probabilities_to_kd``
on the CPU, on every route of the port: the device chain (``use_device``,
``device="cpu"``), the host scipy chain, and windows of a resident
probability map. Label volumes and object counts are equal
(``array_equal``), also after a crashed run resumes.
"""

import logging

import numpy as np
import pytest
import torch

from syconn_tpu.io.chunked import ChunkedVolume as JVolume
from syconn_tpu_torch.extraction import object_extraction as toe
from syconn_tpu_torch.io import resident
from syconn_tpu_torch.io.chunked import ChunkedVolume as TVolume


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU: torch's
    default of one thread per core in every process oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def jax_wd(working_dir):
    """The JAX package's working directory, on its single-chip path."""
    from _torch_helpers import jax_defaults_isolated
    from syconn_tpu import global_params
    from syconn_tpu.handler.config import generate_default_conf

    with jax_defaults_isolated():  # the override stays in this working directory
        generate_default_conf(working_dir, scaling=(10, 10, 20),
                              key_value_pairs=[("tpu", {"shard_pipeline": False})],
                              force_overwrite=True)
    global_params.wd = working_dir
    resident.clear()
    yield working_dir
    resident.clear()


def _two_blobs():
    # tests/test_extraction.py::test_from_probabilities_to_kd
    prob = np.zeros((64, 64, 32), np.uint8)
    prob[10:20, 10:20, 10:20] = 255
    prob[28:40, 28:40, 8:24] = 255  # crosses the x = 32 chunk border
    return prob, (10, 10, 20), dict(thresh_uint8=128, morph_ops=[], chunk_shape=(32, 32, 32))


def _touching_slabs():
    # the volume of tests/test_extraction.py::test_extraction_with_watershed_split,
    # the two slabs joined by a thin neck
    prob = np.zeros((40, 24, 24), np.uint8)
    prob[4:17, 4:20, 4:20] = 255
    prob[21:36, 4:20, 4:20] = 255
    prob[17:21, 10:13, 10:13] = 200
    return prob, (10, 10, 10), dict(thresh_uint8=128, morph_ops=["binary_erosion"] * 2,
                                    min_seed_vx=5, chunk_shape=(64, 64, 64))


def _noisy_blobs():
    # tests/test_resident.py::test_resident_object_extraction_identical
    rng = np.random.default_rng(3)
    prob = (rng.random((96, 48, 48)) * 255).astype(np.uint8)
    prob[10:40, 10:40, 10:40] = 255
    prob[50:90, 8:30, 8:30] = 230
    return prob, (10, 10, 20), dict(thresh_uint8=128,
                                    morph_ops=["binary_closing", "binary_erosion"],
                                    min_seed_vx=2, chunk_shape=(32, 48, 48))


CASES = {"two_blobs": _two_blobs, "touching_slabs": _touching_slabs,
         "noisy_blobs": _noisy_blobs}


def _stores(tmp_path, prob, scale, chunk):
    j, t = str(tmp_path / "j_prob"), str(tmp_path / "t_prob")
    JVolume.create(j, scale=scale, boundary=prob.shape, chunk_shape=chunk).save_raw(prob)
    TVolume.create(t, scale=scale, boundary=prob.shape, chunk_shape=chunk).save_raw(prob)
    return j, t


@pytest.mark.parametrize("route", ["device", "host", "resident"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_from_probabilities_to_kd_matches_jax(tmp_path, jax_wd, case, route):
    from syconn_tpu.extraction.object_extraction import from_probabilities_to_kd

    prob, scale, kw = CASES[case]()
    j, t = _stores(tmp_path, prob, scale, kw["chunk_shape"])
    ref_stats = from_probabilities_to_kd(j, str(tmp_path / "j_seg"), mesh=None, **kw)
    ref = JVolume.open(str(tmp_path / "j_seg")).load_seg(size=prob.shape)
    if route == "resident":
        assert resident.put(t, "raw", prob, device="cpu")
    stats = toe.from_probabilities_to_kd(t, str(tmp_path / "t_seg"), use_device=route != "host",
                                         device="cpu", **kw)
    got = TVolume.open(str(tmp_path / "t_seg")).load_seg(size=prob.shape)
    assert stats["route"] == route
    assert stats["n_objects"] == ref_stats["n_objects"] > 0
    assert stats["halo"] == ref_stats["halo"]
    assert np.array_equal(got, ref)
    if case == "touching_slabs":
        assert stats["n_objects"] == 2  # the erosion-seeded watershed split them


def test_object_segmentation_chunk_matches_jax():
    from syconn_tpu.extraction.object_extraction import object_segmentation_chunk
    from syconn_tpu.ops.morphology import get_aniso_struct

    struct = get_aniso_struct((10, 10, 20))
    prob = np.zeros((48, 48, 24), np.uint8)
    prob[8:24, 8:24, 4:20] = 255
    prob[28:44, 8:24, 4:20] = 255
    ops = ["binary_opening", "binary_closing", "binary_erosion"]
    ref = object_segmentation_chunk(prob, 128, ops, struct, min_seed_vx=5, use_device=False)
    for use_device in (True, False):
        got = toe.object_segmentation_chunk(prob, 128, ops, struct, min_seed_vx=5,
                                            use_device=use_device, device="cpu")
        assert got.dtype == np.uint32 and np.array_equal(got, ref)


class _FailOnce:
    def __init__(self, fn, fail_at):
        self.fn, self.calls, self.fail_at, self.armed = fn, 0, fail_at, True

    def __call__(self, *a, **kw):
        self.calls += 1
        if self.armed and self.calls >= self.fail_at:
            raise RuntimeError("injected crash")
        return self.fn(*a, **kw)


def test_resumed_run_equals_clean_run(tmp_path, monkeypatch, caplog):
    """tests/test_resume.py::test_object_extraction_resume on the port."""
    prob = np.zeros((128, 64, 48), np.uint8)
    prob[4:60, 4:28, 4:20] = 255
    prob[70:120, 10:50, 8:40] = 255
    src = str(tmp_path / "prob")
    TVolume.create(src, scale=(10, 10, 20), boundary=prob.shape,
                   chunk_shape=(32, 32, 48)).save_raw(prob)
    kw = dict(thresh_uint8=128, morph_ops=["binary_closing"], min_seed_vx=1,
              chunk_shape=(32, 32, 48), device="cpu")
    toe.from_probabilities_to_kd(src, str(tmp_path / "seg_clean"), **kw)
    golden = TVolume.open(str(tmp_path / "seg_clean")).load_seg(size=prob.shape)
    failer = _FailOnce(toe.encode_chunk_labels, fail_at=5)
    monkeypatch.setattr(toe, "encode_chunk_labels", failer)
    with pytest.raises(RuntimeError, match="injected"):
        toe.from_probabilities_to_kd(src, str(tmp_path / "seg_resumed"), n_workers=1, **kw)
    failer.armed = False
    caplog.set_level(logging.INFO, logger="syconn_tpu_torch.stepcache")
    stats = toe.from_probabilities_to_kd(src, str(tmp_path / "seg_resumed"), n_workers=1,
                                         overwrite=False, **kw)
    assert any("resume:" in r.message for r in caplog.records)
    assert stats["resumed"] == 4
    resumed = TVolume.open(str(tmp_path / "seg_resumed")).load_seg(size=prob.shape)
    assert np.array_equal(golden, resumed)


def test_kd_init_takes_the_default_config(tmp_path, jax_wd):
    """kd_init's settings are those of default_config.yml, as the JAX
    package's generate_subcell_kd_from_proba reads them."""
    from syconn_tpu import global_params
    from syconn_tpu.extraction.object_extraction import generate_subcell_kd_from_proba
    from syconn_tpu_torch import global_params as tparams
    from syconn_tpu_torch.exec.exec_init import kd_init

    cfg = global_params.config
    tcfg = tparams.config  # no working directory: the packaged defaults
    assert tcfg.working_dir is None
    assert list(tcfg["process_cell_organelles"]) == list(cfg["process_cell_organelles"])
    for key in ("min_obj_vx", "probathresholds", "min_seed_vx", "extract_morph_op"):
        assert tcfg["cell_objects"][key] == dict(cfg["cell_objects"][key]), key
    rng = np.random.default_rng(5)
    prob = (rng.random((64, 48, 32)) * 100).astype(np.uint8)
    prob[8:40, 8:40, 6:26] = 230
    prob[30:60, 20:46, 4:28] = 200
    JVolume.create(cfg.kd_organelle_proba_paths["vc"], scale=(10, 10, 20), boundary=prob.shape,
                   chunk_shape=(32, 32, 32)).save_raw(prob)
    ref_stats = generate_subcell_kd_from_proba("vc", chunk_size=(32, 32, 32))
    ref = JVolume.open(cfg.kd_organelle_seg_paths["vc"]).load_seg(size=prob.shape)
    t = str(tmp_path / "t_vc_prob")
    TVolume.create(t, scale=(10, 10, 20), boundary=prob.shape,
                   chunk_shape=(32, 32, 32)).save_raw(prob)
    stats = kd_init("vc", chunk_size=(32, 32, 32), proba_path=t,
                    target_path=str(tmp_path / "t_vc_seg"), device="cpu")
    got = TVolume.open(str(tmp_path / "t_vc_seg")).load_seg(size=prob.shape)
    assert stats["n_objects"] == ref_stats["n_objects"] > 0
    assert np.array_equal(got, ref)
