"""The port's ``ResidentDensePredictor`` and the resident branch of
``predict_dense_to_kd`` against the JAX package on the CPU, at random init
(features (16, 32), one stride-2 level, patch (2, 2, 2)).

Tolerances (tests/test_models_dense.py:179-215 and the dense slice's):
port against JAX, uint8 probabilities within 2 LSB on >= 99.9% of values;
tile_batch 1 against 4 within 3 LSB (another batch size may take another
convolution algorithm); at one batch size, deterministic. Resident against
streaming on disk: equal at tile_batch 1 (the same forward on the same
windows), within 3 LSB with the argmax stable on >= 99.9% at tile_batch 4;
the registered class maps equal what is on disk.
"""

import jax
import numpy as np
import pytest
import torch

from syconn_tpu.inference import dense as jdense
from syconn_tpu.models import io as jio
from syconn_tpu.models.unet3d import UNet3D as JUNet
from syconn_tpu_torch.inference import dense as tdense
from syconn_tpu_torch.io import resident
from syconn_tpu_torch.io.chunked import ChunkedVolume
from syconn_tpu_torch.models.convert import module_state_from_flax
from syconn_tpu_torch.models.unet3d import UNet3D as TUNet


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs files in parallel processes on a shared CPU: torch's
    default of one thread per core in every process oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

ARCH = dict(features=(16, 32), strides=((2, 2, 2),), patch=(2, 2, 2), n_classes=2)
KW = dict(tile_shape=(32, 32, 32), halo=(8, 8, 8), mode="probs")
_CACHE = {}


def _models():
    if not _CACHE:
        jm = JUNet(**ARCH)
        jp = jio.init_model_params(jm, (1, 32, 32, 32, 1))
        params = jax.tree_util.tree_map(np.asarray, jax.device_get(jp))
        tm = TUNet(**ARCH)
        tm.load_state_dict(module_state_from_flax(params))
        _CACHE.update(jm=jm, jp=jp, tm=tm, tp=params)
    return _CACHE["jm"], _CACHE["jp"], _CACHE["tm"], _CACHE["tp"]


def _vol(seed=3, shape=(96, 64, 32)):  # 3 x 2 x 1 = 6 tiles
    return np.random.default_rng(seed).integers(0, 255, shape, dtype=np.uint8)


@pytest.fixture()
def clean_store(monkeypatch):
    monkeypatch.delenv("SYCONN_TORCH_RESIDENT_TILE_BATCH", raising=False)
    resident.clear()
    yield resident
    resident.clear()


def test_resident_predictor_matches_jax(clean_store):
    jm, jp, tm, tp = _models()
    vol = _vol()
    jr = jdense.ResidentDensePredictor(jm, jp, tile_batch=4, **KW)
    tr = tdense.ResidentDensePredictor(tm, tp, tile_batch=4, device="cpu", **KW)
    jpk, jg = jr.predict_volume_packed(vol)
    tpk, tg = tr.predict_volume_packed(vol)
    assert tg == jg == (3, 2, 1)
    d = np.abs(tpk.numpy().astype(np.int16) - np.asarray(jpk).astype(np.int16))
    assert np.mean(d <= 2) >= 0.999, (float(np.mean(d <= 2)), int(d.max()))
    assert tr.n_forward == 2  # 6 tiles in groups of 4, the last padded
    for c in range(2):
        ref = np.asarray(jr.class_volume_device(jpk, jg, c, vol.shape))
        got = tr.class_volume_device(tpk, tg, c, vol.shape).numpy()
        d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        assert got.shape == vol.shape and np.mean(d <= 2) >= 0.999


def test_tile_batch_and_streaming_parity(clean_store):
    _, _, tm, tp = _models()
    vol = _vol()
    r1 = tdense.ResidentDensePredictor(tm, tp, tile_batch=1, device="cpu", **KW)
    r4 = tdense.ResidentDensePredictor(tm, tp, tile_batch=4, device="cpu", **KW)
    assert r4.tile_batch == 4
    p1, g1 = r1.predict_volume_packed(vol)
    p4, g4 = r4.predict_volume_packed(vol)
    assert g1 == g4 == (3, 2, 1)
    assert int((p1.int() - p4.int()).abs().max()) <= 3
    p4b, _ = r4.predict_volume_packed(vol)
    assert np.array_equal(p4.numpy(), p4b.numpy())
    full = tdense.DenseTilePredictor(tm, tp, device="cpu", **KW).predict_array(vol)
    for packed, r, tol in ((p1, r1, 0), (p4, r4, 3)):
        assembled = np.stack([r.class_volume_device(packed, g1, c, vol.shape).numpy()
                              for c in range(2)], axis=-1)
        assert int(np.abs(assembled.astype(np.int16) - full.astype(np.int16)).max()) <= tol
        assert np.mean(assembled.argmax(-1) != full.argmax(-1)) < 1e-3


def test_masks_mode_class_volume(clean_store):
    _, _, tm, tp = _models()
    vol = _vol(4)
    kw = dict(KW, mode="masks")
    r = tdense.ResidentDensePredictor(tm, tp, tile_batch=1, device="cpu", **kw)
    packed, grid = r.predict_volume_packed(vol)
    full = tdense.DenseTilePredictor(tm, tp, device="cpu", **kw).predict_array(vol)
    for c in range(2):
        got = r.class_volume_device(packed, grid, c, vol.shape).numpy()
        assert set(np.unique(got).tolist()) <= {0, 255}
        assert np.array_equal(got == 255, full[c])


@pytest.mark.parametrize("tile_batch", ["1", "4"])
def test_resident_predict_dense_to_kd_matches_streaming(tmp_path, clean_store, monkeypatch,
                                                        tile_batch):
    _, _, tm, tp = _models()
    vol = _vol(1, (64, 64, 32))
    src = str(tmp_path / "src")
    ChunkedVolume.create(src, scale=(10, 10, 20), boundary=vol.shape,
                         chunk_shape=(64, 64, 32)).save_raw(vol)
    kw = dict(model=tm, params=tp, channel_mapping={"mi": 1, "vc": 0}, tile_shape=(32, 32, 32),
              halo=(8, 8, 8), target_mags=(1,), show_progress=False, device="cpu")
    stream = tdense.predict_dense_to_kd(src, {"mi": str(tmp_path / "miA"),
                                              "vc": str(tmp_path / "vcA")}, **kw)
    assert stream["route"] == "stream"
    assert clean_store.put(src, "raw", vol, device="cpu")
    monkeypatch.setenv("SYCONN_TORCH_RESIDENT_TILE_BATCH", tile_batch)
    stats = tdense.predict_dense_to_kd(src, {"mi": str(tmp_path / "miB"),
                                             "vc": str(tmp_path / "vcB")}, **kw)
    assert stats["route"] == "resident" and stats["tile_batch"] == int(tile_batch)
    assert stats["slabs"] == 1 and sorted(stats["registered"]) == ["mi", "vc"]
    assert stats["tiles"] == 4 and stats["dispatches"] == 1 + 4 // int(tile_batch)
    maps = {}
    for name in ("mi", "vc"):
        a = ChunkedVolume.open(str(tmp_path / f"{name}A")).load_raw(size=vol.shape)
        b = ChunkedVolume.open(str(tmp_path / f"{name}B")).load_raw(size=vol.shape)
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert int(d.max()) <= (0 if tile_batch == "1" else 3), name
        dev = clean_store.get(str(tmp_path / f"{name}B"), "raw")
        assert dev is not None and np.array_equal(dev.numpy(), b)
        maps[name] = (a, b)
    flips = np.mean((maps["mi"][0] > maps["vc"][0]) != (maps["mi"][1] > maps["vc"][1]))
    assert flips < 1e-3


def test_z_slabs_and_skipped_registration(tmp_path, clean_store, monkeypatch):
    """Above the 2 GiB rule the volume runs in z-slabs (drained to the host
    one by one) and no class map is registered."""
    _, _, tm, tp = _models()
    vol = _vol(2, (32, 32, 96))
    src = str(tmp_path / "src")
    ChunkedVolume.create(src, scale=(10, 10, 20), boundary=vol.shape,
                         chunk_shape=(32, 32, 32)).save_raw(vol)
    assert clean_store.put(src, "raw", vol, device="cpu")
    # as the JAX package counts them: 16 x 16 x 16 patched voxels x 128 lanes
    pred = tdense.ResidentDensePredictor(tm, tp, device="cpu", **KW)
    assert tdense._packed_tile_bytes(pred) == 16 * 16 * 16 * 128
    monkeypatch.setattr(tdense, "_packed_tile_bytes", lambda p: 1 << 30)  # 2 layers a slab
    stats = tdense.predict_dense_to_kd(
        src, {"mi": str(tmp_path / "mi")}, tm, tp, {"mi": 1}, tile_shape=(32, 32, 32),
        halo=(8, 8, 8), target_mags=(1,), show_progress=False, device="cpu")
    assert stats["route"] == "resident" and stats["slabs"] == 2 and stats["registered"] == []
    assert clean_store.get(str(tmp_path / "mi"), "raw") is None
    out = ChunkedVolume.open(str(tmp_path / "mi")).load_raw(size=vol.shape)
    assert out.shape == vol.shape and int(out.max()) > int(out.min())


def test_tile_batch_env_override(monkeypatch):
    _, _, tm, tp = _models()
    monkeypatch.setenv("SYCONN_TORCH_RESIDENT_TILE_BATCH", "2")
    assert tdense.ResidentDensePredictor(tm, tp, tile_batch=8, device="cpu",
                                         **KW).tile_batch == 2
    monkeypatch.setenv("SYCONN_TORCH_RESIDENT_TILE_BATCH", "0")
    assert tdense.ResidentDensePredictor(tm, tp, device="cpu", **KW).tile_batch == 1
    monkeypatch.delenv("SYCONN_TORCH_RESIDENT_TILE_BATCH")
    assert tdense.ResidentDensePredictor(tm, tp, device="cpu", **KW).tile_batch == 4


@pytest.mark.parametrize("mode,thresholds", [("probs", (0.3, 0.7)), ("masks", (0.6, 0.45))])
def test_oom_halves_the_batch_then_shrinks_the_tile(tmp_path, clean_store, monkeypatch,
                                                    caplog, mode, thresholds):
    """A device OOM halves tile_batch down to 1, then shrinks the tile and
    rebuilds the predictor with the call's mode and thresholds; an OOM in
    the class-map reassembly skips the registration (logged) and the
    outputs still reach the disk."""
    import logging

    _, _, tm, tp = _models()
    vol = _vol(6, (128, 64, 32))  # two tiles of (64, 64, 32)
    src = str(tmp_path / "src")
    ChunkedVolume.create(src, scale=(10, 10, 20), boundary=vol.shape,
                         chunk_shape=(64, 64, 32)).save_raw(vol)
    assert clean_store.put(src, "raw", vol, device="cpu")
    real = tdense.DenseTilePredictor._forward
    seen, made = [], set()

    def flaky(self, x):
        seen.append((int(x.shape[0]), tuple(int(t) for t in self.tile_shape)))
        made.add((seen[-1][1], self.mode, tuple(self._on[self._home][1].flatten().tolist())))
        if len(seen) > 1 and self.tile_shape[0] == 64:  # the first-dispatch probe passes
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 8.00 GiB")
        return real(self, x)

    def no_room(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (reassembly)")

    monkeypatch.setattr(tdense.DenseTilePredictor, "_forward", flaky)
    monkeypatch.setattr(tdense.ResidentDensePredictor, "class_volume_device", no_room)
    caplog.set_level(logging.WARNING, logger="syconn_tpu_torch.inference")
    stats = tdense.predict_dense_to_kd(
        src, {"mi": str(tmp_path / "mi")}, tm, tp, {"mi": 1}, tile_shape=(64, 64, 32),
        halo=(8, 8, 8), target_mags=(1,), show_progress=False, device="cpu", mode=mode,
        thresholds=thresholds)
    # the probe; tile_batch 4 and 2 (both one batch of the two tiles), 1;
    # then the tile shrinks
    assert [b for b, ts in seen if ts == (64, 64, 32)] == [1, 2, 2, 1]
    assert stats["tile_shape"] == [32, 64, 32] and stats["route"] == "resident"
    thr = tuple(np.asarray(thresholds, np.float32).tolist())
    assert made == {((64, 64, 32), mode, thr), ((32, 64, 32), mode, thr)}
    assert stats["registered"] == [] and clean_store.get(str(tmp_path / "mi"), "raw") is None
    assert any("skipping resident registration" in r.message for r in caplog.records)
    out = ChunkedVolume.open(str(tmp_path / "mi")).load_raw(size=vol.shape)
    assert out.shape == vol.shape and int(out.max()) > int(out.min())
    if mode == "masks":
        assert set(np.unique(out).tolist()) == {0, 255}
    # the batch halving alone, on a volume of 4 tiles
    monkeypatch.setattr(tdense.DenseTilePredictor, "_forward",
                        lambda self, x: (_ for _ in ()).throw(torch.cuda.OutOfMemoryError(
                            "CUDA out of memory")) if x.shape[0] > 1 else real(self, x))
    r = tdense.ResidentDensePredictor(tm, tp, tile_batch=4, device="cpu", **KW)
    packed, grid = r.predict_volume_packed(_vol(7, (64, 64, 32)))
    assert r.tile_batch == 1 and grid == (2, 2, 1) and packed.shape[0] == 4
