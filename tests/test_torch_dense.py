"""The port's dense-prediction slice against the JAX package on the CPU:
``predict_dense_to_kd`` / ``predict_myelin`` with the packaged weights at
full width, the tile-shrink policy and OOM retry, and the chunk store.

Tolerances: probs mode uint8 maps within 2 LSB on >= 99.9% of voxels;
masks mode (threshold 248/255, device rule ``p >= thr/255``) equal on
>= 99.9% of voxels.
"""

import numpy as np
import pytest
import torch

from syconn_tpu.inference import dense as jdense
from syconn_tpu.io.chunked import ChunkedVolume as JVolume
from syconn_tpu.models import io as jio
from syconn_tpu_torch.exec.exec_dense_prediction import predict_myelin
from syconn_tpu_torch.inference import dense as tdense
from syconn_tpu_torch.io.chunked import ChunkedVolume as TVolume
from syconn_tpu_torch.models import io as tio

SHAPE = (64, 64, 32)
TILE = dict(tile_shape=(64, 64, 32), halo=(8, 8, 4))  # input 80x80x40 -> patched 20^3


def _volume(seed=0):
    return np.random.default_rng(seed).integers(0, 255, SHAPE, dtype=np.uint8)


def _stores(tmp_path, vol):
    jsrc, tsrc = str(tmp_path / "jax_raw"), str(tmp_path / "torch_raw")
    JVolume.create(jsrc, scale=(10, 10, 20), boundary=SHAPE, chunk_shape=(32, 32, 32)).save_raw(vol)
    TVolume.create(tsrc, scale=(10, 10, 20), boundary=SHAPE, chunk_shape=(32, 32, 32)).save_raw(vol)
    return jsrc, tsrc


def test_probs_mode_matches_jax(tmp_path):
    vol = _volume()
    jsrc, tsrc = _stores(tmp_path, vol)
    jm, jp = jio.load_model(jio.packaged_model_path("syntype"))
    tm, tp = tio.load_model(tio.packaged_model_path("syntype"))
    chans = {"asym": 1, "sym": 2}
    jpred = jdense.DenseTilePredictor(jm, jp, mode="probs", **TILE)
    jdense.predict_dense_to_kd(jsrc, {k: str(tmp_path / f"j_{k}") for k in chans}, jm, jp, chans,
                               predictor=jpred, target_mags=(1,), show_progress=False, **TILE)
    stats = tdense.predict_dense_to_kd(tsrc, {k: str(tmp_path / f"t_{k}") for k in chans}, tm, tp,
                                       chans, target_mags=(1,), device="cpu",
                                       show_progress=False, **TILE)
    assert stats["n_voxels"] == int(np.prod(SHAPE)) and stats["dispatches"] == 2
    for k in chans:
        ref = JVolume.open(str(tmp_path / f"j_{k}")).load_raw(size=SHAPE)
        got = TVolume.open(str(tmp_path / f"t_{k}")).load_raw(size=SHAPE)
        d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        assert np.mean(d <= 2) >= 0.999, (k, float(np.mean(d <= 2)), int(d.max()))
        assert int(got.max()) > int(got.min())


def test_masks_mode_myelin_matches_jax(tmp_path):
    vol = _volume(1)
    jsrc, tsrc = _stores(tmp_path, vol)
    jm, jp = jio.load_model(jio.packaged_model_path("myelin"))
    thr = jio.load_model_meta(jio.packaged_model_path("myelin"))["threshold"]
    thresholds = [0.5, thr / 255.0]
    jpred = jdense.DenseTilePredictor(jm, jp, mode="masks", thresholds=thresholds, **TILE)
    jdense.predict_dense_to_kd(jsrc, {"myelin": str(tmp_path / "j_my")}, jm, jp, {"myelin": 1},
                               predictor=jpred, target_mags=(1,), mode="masks",
                               thresholds=thresholds, show_progress=False, **TILE)
    stats = predict_myelin(kd_path=tsrc, target_paths={"myelin": str(tmp_path / "t_my")}, device="cpu",
                           show_progress=False, **TILE)
    assert stats["tile_shape"] == list(TILE["tile_shape"])
    ref = JVolume.open(str(tmp_path / "j_my")).load_raw(size=SHAPE)
    got = TVolume.open(str(tmp_path / "t_my")).load_raw(size=SHAPE)
    assert set(np.unique(got).tolist()) <= {0, 255}
    assert np.mean(got == ref) >= 0.999, float(np.mean(got == ref))


@pytest.mark.parametrize("ts,h,p", [
    ((64, 64, 32), (8, 8, 8), (2, 2, 2)),
    ((256, 256, 128), (32, 32, 16), (4, 4, 2)),
    ((4, 4, 2), (0, 0, 0), (4, 4, 2)),
    ((32, 96, 16), (16, 16, 8), (4, 4, 2)),
])
def test_shrink_tile_shape_matches_jax(ts, h, p):
    assert tdense.shrink_tile_shape(ts, h, p) == jdense.shrink_tile_shape(ts, h, p)


def test_oom_adaptive_tile_shrink(tmp_path, monkeypatch):
    """A device OOM at the first dispatch shrinks the tile and retries."""
    tm, tp = tio.load_model(tio.packaged_model_path("myelin"))
    vol = _volume(2)
    _, tsrc = _stores(tmp_path, vol)
    real = tdense.DenseTilePredictor.dispatch
    state = {"failed": False, "tiles": []}

    def flaky(self, x):
        state["tiles"].append(tuple(int(t) for t in self.tile_shape))
        if not state["failed"] and state["tiles"][-1] == (64, 64, 32):
            state["failed"] = True
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return real(self, x)

    monkeypatch.setattr(tdense.DenseTilePredictor, "dispatch", flaky)
    stats = tdense.predict_dense_to_kd(tsrc, {"a": str(tmp_path / "a")}, tm, tp, {"a": 1},
                                       tile_shape=(64, 64, 32), halo=(8, 8, 4), target_mags=(1,),
                                       device="cpu", show_progress=False)
    assert state["failed"] and (32, 64, 32) in state["tiles"]
    assert stats["tile_shape"] == [32, 64, 32] and stats["n_voxels"] == int(np.prod(SHAPE))
    assert TVolume.open(str(tmp_path / "a")).load_raw(size=SHAPE).shape == SHAPE
    # an error that is not an OOM is raised, not retried
    monkeypatch.setattr(tdense.DenseTilePredictor, "dispatch",
                        lambda self, x: (_ for _ in ()).throw(ValueError("bad input")))
    with pytest.raises(ValueError, match="bad input"):
        tdense.predict_dense_to_kd(tsrc, {"b": str(tmp_path / "b")}, tm, tp, {"b": 1},
                                   tile_shape=(64, 64, 32), halo=(8, 8, 4), device="cpu")


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_chunked_volume_roundtrip(tmp_path, codec):
    """Both codecs round-trip raw and seg data (unaligned writes, mag 2) and
    decode to what the JAX store holds for the same writes."""
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 255, (40, 36, 20), dtype=np.uint8)
    seg = rng.integers(0, 70000, (40, 36, 20)).astype(np.uint64)
    kw = dict(scale=(10, 10, 20), boundary=(72, 64, 48), chunk_shape=(16, 16, 16))
    t = TVolume.create(str(tmp_path / "t"), codec=codec, **kw)
    j = JVolume.create(str(tmp_path / "j"), **kw)
    for v in (t, j):
        v.save_raw(raw, offset=(4, 6, 8), mags=(1, 2))
        v.save_seg(seg, offset=(4, 6, 8), mags=(1, 2))
    t2 = TVolume.open(str(tmp_path / "t"))
    assert t2.codec == codec and t2.available_mags == [1, 2]
    np.testing.assert_array_equal(t2.load_raw(offset=(4, 6, 8), size=raw.shape), raw)
    np.testing.assert_array_equal(t2.load_seg(offset=(4, 6, 8), size=seg.shape), seg)
    for mag in (1, 2):
        np.testing.assert_array_equal(t2.load_raw(mag=mag), j.load_raw(mag=mag))
        np.testing.assert_array_equal(t2.load_seg(mag=mag), j.load_seg(mag=mag))
    # the port reads a store the JAX package wrote (no codec key: zstd)
    np.testing.assert_array_equal(TVolume.open(str(tmp_path / "j")).load_seg(mag=2), j.load_seg(mag=2))
    with pytest.raises(ValueError, match="aligned"):
        t2.save_raw(raw, offset=(1, 0, 0), mags=(2,))
