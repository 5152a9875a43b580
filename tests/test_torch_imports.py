"""The port imports nothing of JAX, flax, msgpack, PyYAML, networkx or the JAX
package, and its entry points refuse to run silently on the CPU."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "msgpack", "syconn_tpu", "zstandard", "yaml", "h5py",
             "tqdm", "networkx"):
    sys.modules[name] = None
sys.path.insert(0, {root!r})
import syconn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(syconn_tpu_torch.__path__, "syconn_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "flax", "msgpack", "syconn_tpu", "h5py", "tqdm", "networkx")
       and sys.modules[m] is not None]
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax_flax_msgpack_or_reference():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT.format(root=ROOT)],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    import syconn_tpu_torch

    n = len(list(pkgutil.walk_packages(syconn_tpu_torch.__path__, "syconn_tpu_torch.")))
    assert int(out.stdout.strip().splitlines()[-1]) == n >= 59


def test_entry_points_without_device_raise(monkeypatch, tmp_path):
    from syconn_tpu_torch.exec.exec_dense_prediction import predict_synapsetype
    from syconn_tpu_torch.inference.dense import DenseTilePredictor
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.models.io import load_model, packaged_model_path
    from syconn_tpu_torch.utils.device import default_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device("cuda")
    assert default_device("cpu") == torch.device("cpu")
    model, params = load_model(packaged_model_path("myelin"))
    with pytest.raises(RuntimeError, match="CUDA"):
        DenseTilePredictor(model, params, tile_shape=(32, 32, 16), halo=(0, 0, 0))
    kd = str(tmp_path / "raw")
    ChunkedVolume.create(kd, scale=(10, 10, 20), boundary=(32, 32, 16)).save_raw(
        np.zeros((32, 32, 16), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA"):
        predict_synapsetype(kd_path=kd, target_paths={"asym": str(tmp_path / "a"),
                                                   "sym": str(tmp_path / "s")})


def test_contact_entry_points_without_device_raise(monkeypatch, tmp_path):
    """Step 6a's entry points: CUDA or an explicit ``device="cpu"``."""
    from syconn_tpu_torch.exec.exec_syns import run_contact_extraction
    from syconn_tpu_torch.extraction.cs_extraction import extract_contact_site_tables
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.ops.contacts_cuda import detect_cs_cuda
    from syconn_tpu_torch.ops.contacts_torch import CsDispatcher, detect_cs_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seg = np.zeros((20, 20, 12), np.uint32)
    seg[2:9] = 3
    seg[10:18] = 5
    kd = str(tmp_path / "seg")
    ChunkedVolume.create(kd, scale=(10, 10, 20), boundary=seg.shape).save_seg(seg)
    calls = [lambda **kw: run_contact_extraction(kd, str(tmp_path / "o1"), **kw),
             lambda **kw: extract_contact_site_tables(kd, str(tmp_path / "o2"), **kw),
             lambda **kw: detect_cs_cuda(seg, (5, 5, 3), (16, 16), 8, **kw),
             lambda **kw: detect_cs_torch(seg, (5, 5, 3), (16, 16, 8), 8, **kw),
             lambda **kw: CsDispatcher((5, 5, 3), **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        with pytest.raises(RuntimeError, match="CUDA"):
            call(device="cuda")
    res = run_contact_extraction(kd, str(tmp_path / "o3"), stencil=(5, 5, 3),
                                 min_obj_vx={"cs": 1}, device="cpu")
    assert res["n_cs"] == 1 and res["cs"]["partner_ids"].tolist() == [[3, 5]]


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card chip_smoke exits non-zero and prints no result; alone
    in a directory (no package) it does the same."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    out = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_step2_entry_points_without_device_raise(monkeypatch, tmp_path):
    """Step 2's entry points and device functions: CUDA or ``device="cpu"``."""
    from syconn_tpu_torch.exec.exec_init import init_cell_subcell_tables, kd_init
    from syconn_tpu_torch.extraction.object_extraction import (from_probabilities_to_kd,
                                                               object_segmentation_chunk)
    from syconn_tpu_torch.inference.dense import ResidentDensePredictor
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.models.io import load_model, packaged_model_path
    from syconn_tpu_torch.ops.cc import connected_components
    from syconn_tpu_torch.ops.cc_torch import connected_components_torch
    from syconn_tpu_torch.ops.morphology import get_aniso_struct
    from syconn_tpu_torch.ops.morphology_torch import (morphology_chain_device,
                                                       segment_chunk_device)
    from syconn_tpu_torch.ops.props_torch import object_properties_torch, pair_counts_torch
    from syconn_tpu_torch.proc.sd_proc import map_subcell_extract_props_tables

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = np.zeros((24, 24, 12), np.uint8)
    prob[4:12, 4:12, 2:8] = 200
    seg = (prob > 0).astype(np.uint64) * 3
    paths = {n: str(tmp_path / n) for n in ("prob", "seg")}
    ChunkedVolume.create(paths["prob"], scale=(10, 10, 20), boundary=prob.shape).save_raw(prob)
    ChunkedVolume.create(paths["seg"], scale=(10, 10, 20), boundary=prob.shape).save_seg(seg)
    struct = get_aniso_struct((10, 10, 20))
    model, params = load_model(packaged_model_path("organelles"))
    out = str(tmp_path / "out")
    calls = [
        lambda **kw: kd_init("mi", proba_path=paths["prob"], target_path=out, **kw),
        lambda **kw: init_cell_subcell_tables(paths["seg"], {"mi": paths["prob"],
                                                             "vc": paths["prob"]},
                                              {"mi": out + "_mi", "vc": out + "_vc"}, **kw),
        lambda **kw: from_probabilities_to_kd(paths["prob"], out, 128, [], **kw),
        lambda **kw: from_probabilities_to_kd(paths["prob"], out, 128, [], use_device=False,
                                              **kw),
        lambda **kw: object_segmentation_chunk(prob, 128, [], struct, 1, **kw),
        lambda **kw: map_subcell_extract_props_tables(paths["seg"], {}, **kw),
        lambda **kw: morphology_chain_device(prob > 0, ["binary_erosion"], struct, **kw),
        lambda **kw: segment_chunk_device(prob, 128, [], struct, **kw),
        lambda **kw: connected_components_torch(prob > 0, **kw),
        lambda device=None: connected_components(prob > 0, device=device),
        lambda **kw: object_properties_torch(seg, **kw),
        lambda **kw: pair_counts_torch(seg, seg, **kw),
        lambda **kw: ResidentDensePredictor(model, params, tile_shape=(32, 32, 16),
                                            halo=(0, 0, 0), **kw),
    ]
    for call in calls:
        for kw in ({}, {"device": "cuda"}):
            with pytest.raises(RuntimeError, match="CUDA"):
                call(**kw)
    assert connected_components(prob > 0)[1] == 1  # the host default: scipy
    res = init_cell_subcell_tables(paths["seg"], {"mi": paths["prob"], "vc": paths["prob"]},
                                   {"mi": out + "_mi", "vc": out + "_vc"}, chunk_size=(24, 24, 12),
                                   device="cpu")
    assert res["counts"]["sv"] == 1 and res["stats"]["cell_route"] == "host"
    assert res["extraction"]["vc"]["n_objects"] == 1  # mi's four erosions leave no seed


def test_config_driven_entry_points_without_device_raise(monkeypatch, tmp_path):
    """The working-directory entry points of steps 1, 2 and 6a: CUDA or
    ``device="cpu"``."""
    from _torch_helpers import port_wd
    from syconn_tpu_torch.exec.exec_dense_prediction import predict_cellorganelles
    from syconn_tpu_torch.exec.exec_init import init_cell_subcell_sds
    from syconn_tpu_torch.exec.exec_syns import run_syn_generation
    from syconn_tpu_torch.extraction.cs_extraction import extract_contact_sites
    from syconn_tpu_torch.handler.config import generate_default_conf
    from syconn_tpu_torch.io.chunked import ChunkedVolume

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wd = str(tmp_path / "wd")
    generate_default_conf(wd, scaling=(10, 10, 20))
    seg = np.zeros((32, 32, 16), np.uint64)
    seg[2:15] = 3
    seg[16:30] = 5
    with port_wd(wd) as cfg:
        kd = ChunkedVolume.create(cfg.kd_seg_path, scale=(10, 10, 20), boundary=seg.shape)
        kd.save_seg(seg)
        kd.save_raw(np.full(seg.shape, 128, np.uint8))
        for co in ("mi", "vc"):
            ChunkedVolume.create(cfg.kd_organelle_proba_paths[co], scale=(10, 10, 20),
                                 boundary=seg.shape).save_raw(np.zeros(seg.shape, np.uint8))
        calls = [lambda **kw: predict_cellorganelles(show_progress=False, **kw),
                 lambda **kw: init_cell_subcell_sds(chunk_size=(32, 32, 16), **kw),
                 lambda **kw: extract_contact_sites(chunk_shape=(32, 32, 16), **kw),
                 lambda **kw: run_syn_generation(chunk_size=(32, 32, 16),
                                                 until="extract_contact_sites", **kw)]
        for call in calls:
            for kw in ({}, {"device": "cuda"}):
                with pytest.raises(RuntimeError, match="CUDA"):
                    call(**kw)
        counts = init_cell_subcell_sds(chunk_size=(32, 32, 16), device="cpu")
        res = run_syn_generation(chunk_size=(32, 32, 16), until="extract_contact_sites",
                                 device="cpu")
    assert counts["sv"] == 2 and counts["mi"] == counts["vc"] == 0
    assert res["n_cs"] == 1
