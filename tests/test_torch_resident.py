"""The port's device-resident volume store against ``syconn_tpu.io.resident``
(enabled there with SYCONN_TPU_RESIDENT=1, as tests/test_resident.py does).
Volumes are placed on the CPU here; values are integers, compared exactly."""

import numpy as np
import pytest
import torch

from syconn_tpu_torch.io import resident as TR


@pytest.fixture()
def stores(monkeypatch):
    from syconn_tpu.io import resident as JR

    monkeypatch.setenv("SYCONN_TPU_RESIDENT", "1")
    monkeypatch.setattr(JR, "_TRIPPED", False)
    JR.clear()
    TR.clear()
    yield JR, TR
    JR.clear()
    TR.clear()


def test_put_get_derive_drop_match_jax_store(tmp_path, stores):
    JR, TR_ = stores
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 255, (64, 34, 17), np.uint8)  # odd extents: pyramid crops
    seg = rng.integers(0, 9, (64, 34, 17), np.uint64)
    p = str(tmp_path / "v")
    assert JR.put(p, "raw", raw) and JR.put(p, "seg", seg)
    assert TR_.put(p, "raw", raw, device="cpu") and TR_.put(p, "seg", seg, device="cpu")
    for ch in ("raw", "seg"):
        for mag in (1, 2, 4):
            a = np.asarray(JR.get(p, ch, mag))
            b = TR_.get(p, ch, mag)
            assert b.dtype == (torch.uint8 if ch == "raw" else torch.int32)
            assert np.array_equal(a, TR_.fetch(b)), (ch, mag)
    assert TR_.get(p, "raw", 3) is None and TR_.get(p, "raw", 8, derive=False) is None
    assert TR_.get(str(tmp_path / "other"), "raw") is None
    # derived levels are cached and counted
    assert TR_.stats()["n_volumes"] == JR.stats()["n_volumes"] == 6
    assert TR_.total_bytes() == JR.total_bytes()
    assert TR_.drop(p, "raw") == JR.drop(p, "raw") == 3
    assert TR_.get(p, "raw") is None and TR_.get(p, "seg") is not None
    assert TR_.drop(p) == JR.drop(p) == 3
    assert TR_.total_bytes() == 0


def test_budget_and_id_refusals_match_jax_store(tmp_path, stores, monkeypatch):
    JR, TR_ = stores
    monkeypatch.setattr(JR, "_budget_bytes", lambda: 100_000)
    gb = 100_000 / (1 << 30)
    big = np.zeros((128, 128, 16), np.uint8)  # 256 KB
    small = np.zeros((32, 32, 16), np.uint8)
    assert not JR.put(str(tmp_path / "big"), "raw", big)
    assert not TR_.put(str(tmp_path / "big"), "raw", big, device="cpu", budget_gb=gb)
    assert JR.put(str(tmp_path / "small"), "raw", small)
    assert TR_.put(str(tmp_path / "small"), "raw", small, device="cpu", budget_gb=gb)
    # the budget counts what is resident already
    assert not TR_.put(str(tmp_path / "s2"), "raw", small, device="cpu", budget_gb=gb / 4)
    assert TR_.put(str(tmp_path / "big"), "raw", big, device="cpu")
    monkeypatch.setattr(JR, "_budget_bytes", lambda: 10 << 30)
    wide = np.array([[[1, 2**31]]], np.uint64)
    assert not JR.put(str(tmp_path / "wide"), "seg", wide)
    assert not TR_.put(str(tmp_path / "wide"), "seg", wide, device="cpu")
    assert TR_.put(str(tmp_path / "ok"), "seg", np.array([[[1, 2**31 - 1]]], np.uint64),
                   device="cpu")


def test_put_without_card_or_device_is_refused(tmp_path, stores, monkeypatch):
    _, TR_ = stores
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = np.zeros((8, 8, 8), np.uint8)
    assert not TR_.enabled()
    assert not TR_.put(str(tmp_path / "v"), "raw", vol)
    # a tensor that already lives on a device is kept where it is
    assert TR_.put(str(tmp_path / "v"), "raw", torch.from_numpy(vol).to(torch.int64))
    assert TR_.get(str(tmp_path / "v"), "raw").dtype == torch.uint8
    with pytest.raises(RuntimeError, match="CUDA"):
        TR_.put(str(tmp_path / "w"), "raw", vol, device="cuda")
