"""The port imports nothing of JAX, flax, msgpack or the JAX package, and its
entry points refuse to run silently on the CPU."""

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
             "tqdm"):
    sys.modules[name] = None
sys.path.insert(0, {root!r})
import syconn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(syconn_tpu_torch.__path__, "syconn_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "flax", "msgpack", "syconn_tpu", "h5py", "tqdm")
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
    assert int(out.stdout.strip().splitlines()[-1]) == n >= 28


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
        predict_synapsetype(kd, {"asym": str(tmp_path / "a"), "sym": str(tmp_path / "s")})


def test_contact_entry_points_without_device_raise(monkeypatch, tmp_path):
    """Step 6a's entry points: CUDA or an explicit ``device="cpu"``."""
    from syconn_tpu_torch.exec.exec_syns import run_contact_extraction
    from syconn_tpu_torch.extraction.cs_extraction import extract_contact_sites
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
             lambda **kw: extract_contact_sites(kd, str(tmp_path / "o2"), **kw),
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
