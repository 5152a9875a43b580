"""The port's pipeline driver on its other paths, port only, on the CPU at
64x64x32 (tests/test_torch_start.py holds the default path to the JAX
driver):

* ``--predict_organelles``: the mi/vc/sj maps equal a direct
  ``predict_cellorganelles(device="cpu")`` on the driver's raw volume;
* ``--use_views --organelles mi,vc,er,golgi --prior_astrocyte_removal``
  with seed-initialised view nets, at 96x96x48: the asserts of
  tests/test_full_run.py's second variant, and the view route's outputs
  on every cell left after the astrocyte split;
* ``--train_models``: the nets land in ``<wd>/models/`` and the packaged
  weights stay byte-identical;
* ``--until_step 0``, then a run without ``--overwrite``: it resumes on
  the prepared working directory, and ``timing.json`` keeps the steps of
  both runs; a run of another shape starts the file afresh;
* ``--kv`` values read as ``yaml.safe_load`` reads them;
* ``--shard_pipeline`` on one device writes ``tpu.shard_pipeline: true``
  and runs serially; a run without a card and without ``--device cpu``
  raises before anything is written;
* ``--run_server`` calls the port's server ``main`` with the JAX driver's
  arguments once ``timing.json`` is written.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from _torch_helpers import port_wd

BASE = ["--shape", "64", "64", "32", "--n_cells", "3", "--seed", "1"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _run(wd, *extra, stats=None):
    from syconn_tpu_torch.examples import start

    with port_wd(None):
        start.main(["--working_dir", wd, *BASE, "--device", "cpu", *extra], stats=stats)


def _timing(wd):
    with open(os.path.join(wd, "timing.json")) as f:
        return json.load(f)


def test_predict_organelles_equals_direct_prediction(tmp_path):
    from syconn_tpu_torch.exec.exec_dense_prediction import predict_cellorganelles
    from syconn_tpu_torch.io.chunked import ChunkedVolume

    wd = str(tmp_path / "wd")
    stats = {}
    _run(wd, "--overwrite", "--predict_organelles", "--until_step", "0", stats=stats)
    assert stats["organelles"]["dispatches"] > 0
    direct = {co: str(tmp_path / co) for co in ("mi", "vc", "sj")}
    with port_wd(wd) as cfg:
        predict_cellorganelles(mag=1, kd_path=cfg.kd_seg_path, target_paths=direct,
                               device="cpu")
        for co, path in direct.items():
            for mag in (1, 2):
                a = ChunkedVolume.open(getattr(cfg, f"kd_{co}_path")).load_raw(mag=mag)
                b = ChunkedVolume.open(path).load_raw(mag=mag)
                assert np.array_equal(a, b), (co, mag)
        # the generator's map of an organelle is written only where it is not predicted
        assert os.path.isdir(cfg.kd_sym_path)
    assert list(_timing(wd)["steps_s"]) == ["Preparation"]


def test_views_all_organelles_and_astrocyte_removal(tmp_path):
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset

    wd = str(tmp_path / "views_wd")
    # at 96x96x48 the packaged glia net leaves two of the nine supervoxels to
    # the neurons (at 64x64x32 it takes all nine)
    _run(wd, "--overwrite", "--use_views", "--kv", "views.allow_untrained_models=true",
         "--organelles", "mi,vc,er,golgi", "--prior_astrocyte_removal", "--shape", "96", "96",
         "48")
    assert os.path.isfile(os.path.join(wd, "connectivity_matrix", "conn_mat.csv"))
    for co in ("er", "golgi"):
        assert os.path.isdir(os.path.join(wd, f"{co}s_0")) or any(
            d.startswith(co) for d in os.listdir(wd)), co
    assert os.path.isfile(os.path.join(wd, "astrocyte_svgraph.bz2"))
    assert "Astrocyte separation" in _timing(wd)["steps_s"]
    with port_wd(wd):
        ssd = SuperSegmentationDataset(working_dir=wd)
        assert len(ssd.ssv_ids) >= 1
        for i in ssd.ssv_ids:
            ssv = ssd.get_super_segmentation_object(int(i))
            ssv.load_attr_dict()
            assert "celltype_cnn_e3" in ssv.attr_dict and "latent_morph" in ssv.attr_dict
    # the seed-initialised view nets were persisted in the working directory
    assert os.path.isdir(os.path.join(wd, "models"))


def test_train_models_write_the_working_directory(tmp_path):
    from syconn_tpu_torch.models.io import load_model_meta
    from test_torch_trainers import _packaged_bytes

    packaged = _packaged_bytes()
    wd = str(tmp_path / "train_wd")
    stats = {}
    _run(wd, "--overwrite", "--train_models", "--train_steps", "2", "--until_step", "0",
         stats=stats)
    for task in ("organelles", "myelin"):
        assert os.path.isfile(os.path.join(wd, "models", task, "arch.json")), task
    assert load_model_meta(os.path.join(wd, "models", "organelles"))["task"] == "organelles"
    assert stats["organelles"]["dispatches"] > 0  # the trained net predicted the maps
    assert list(_timing(wd)["steps_s"]) == ["Preparation", "Model training"]
    assert _packaged_bytes() == packaged


def test_prepare_then_resume_and_the_timing_merge(tmp_path):
    from syconn_tpu_torch.examples.start import _write_timing_json
    from syconn_tpu_torch.handler import yamlio

    wd = str(tmp_path / "wd")
    _run(wd, "--overwrite", "--until_step", "0", "--kv", "min_cc_size_ssv=300",
         "--kv", "compartments.dist_axoness_averaging=500")
    prep = _timing(wd)
    assert list(prep["steps_s"]) == ["Preparation"] and prep["shape"] == [64, 64, 32]
    conf = yamlio.load(open(os.path.join(wd, "config.yml")).read())
    assert conf["min_cc_size_ssv"] == 300
    assert conf["compartments"]["dist_axoness_averaging"] == 500
    assert "map_properties_semsegax" in conf["compartments"]  # merged into the section

    stats = {}
    _run(wd, "--kv", "min_cc_size_ssv=300", stats=stats)
    assert "world" not in stats  # the prepared world was reused, not generated again
    assert os.path.isfile(os.path.join(wd, "connectivity_matrix", "conn_mat.csv"))
    steps = _timing(wd)["steps_s"]
    assert list(steps)[:2] == ["Preparation", "Dense predictions"] and "Matrix export" in steps

    # the merge keeps the steps of a run of the same shape, cells and world,
    # and starts afresh after a run of another
    class Timer:
        timings = {"SD generation": 1.0}

    same = argparse.Namespace(shape=[64, 64, 32], n_cells=3, world="voronoi")
    _write_timing_json(wd, same, Timer())
    merged = _timing(wd)["steps_s"]
    assert merged == {**steps, "SD generation": 1.0}
    for other in (argparse.Namespace(shape=[64, 64, 48], n_cells=3, world="voronoi"),
                  argparse.Namespace(shape=[64, 64, 48], n_cells=4, world="voronoi"),
                  argparse.Namespace(shape=[64, 64, 48], n_cells=4, world="neuron")):
        _write_timing_json(wd, other, Timer())
        got = _timing(wd)
        assert got["steps_s"] == {"SD generation": 1.0}
        assert (got["shape"], got["n_cells"], got["world"]) == (other.shape, other.n_cells,
                                                                other.world)


@pytest.mark.parametrize("raw", ["500", "true", "0.5", "[1, 2]", "bare_string", "1e3", ""])
def test_kv_values_read_as_yaml_safe_load(raw):
    """The reader ``main`` parses each ``--kv`` value with."""
    yaml = pytest.importorskip("yaml")
    from syconn_tpu_torch.handler import yamlio

    want = yaml.safe_load(raw)
    got = yamlio.load(raw)
    assert got == want and type(got) is type(want)


def test_refusals_before_anything_is_written(tmp_path, monkeypatch):
    """``--shard_pipeline`` writes ``tpu.shard_pipeline: true`` and, with no
    second card (here: ``--device cpu``), runs serially, as the JAX driver
    does on one device; a run without a card and without ``--device cpu``
    raises before anything is written."""
    from syconn_tpu_torch.examples import start
    from syconn_tpu_torch.handler.config import Config

    sharded = str(tmp_path / "sharded")
    stats = {}
    _run(sharded, "--shard_pipeline", "--until_step", "2", stats=stats)
    assert Config(sharded)["tpu"]["shard_pipeline"] is True
    sds = stats["sds"]["stats"]
    assert sds["scan"]["cell_route"] == "host"
    assert {r["route"] for r in sds["extraction"].values() if r} == {"device"}
    _run(str(tmp_path / "serial"), "--no-shard_pipeline", "--until_step", "0")
    assert Config(str(tmp_path / "serial"))["tpu"]["shard_pipeline"] is False
    wd = str(tmp_path / "wd")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        start.main(["--working_dir", wd, *BASE])
    with pytest.raises(RuntimeError, match="CUDA"):
        start.main(["--working_dir", wd, *BASE, "--device", "cuda"])
    assert not os.path.exists(wd)


def test_run_server_after_timing_json(tmp_path, monkeypatch):
    """The JAX driver's ``--run_server`` (``start.py:393-397``): after
    ``timing.json``, ``sys.argv`` becomes the server's arguments and the
    server's ``main`` runs (recorded here instead of binding port 10001)."""
    import sys

    from syconn_tpu_torch.analysis import server

    wd = str(tmp_path / "wd")
    seen = {}

    def fake_main(argv=None):
        seen["argv"] = list(sys.argv)
        seen["timing"] = _timing(wd)

    monkeypatch.setattr(server, "main", fake_main)
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    _run(wd, "--until_step", "6", "--run_server")
    assert seen["argv"] == ["syconn.server", f"--working_dir={wd}", "--port=10001"]
    assert seen["timing"] == _timing(wd) and "Synapse detection" in seen["timing"]["steps_s"]
    seen.clear()
    _run(wd, "--until_step", "0")  # the JAX driver returns before serving here too
    assert seen == {}
