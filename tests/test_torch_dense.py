"""The port's dense-prediction slice against the JAX package on the CPU:
``predict_dense_to_kd`` / ``predict_myelin`` with the packaged weights at
full width, the tile-shrink policy and OOM retry, and the chunk store;
and on the port alone, that the dense step writes each target chunk once.

Tolerances: probs mode uint8 maps within 2 LSB on >= 99.9% of voxels;
masks mode (threshold 248/255, device rule ``p >= thr/255``) equal on
>= 99.9% of voxels.
"""

import os

import numpy as np
import pytest
import torch

from syconn_tpu.inference import dense as jdense
from syconn_tpu.io.chunked import ChunkedVolume as JVolume
from syconn_tpu.models import io as jio
from syconn_tpu_torch.exec.exec_dense_prediction import predict_myelin
from syconn_tpu_torch.inference import dense as tdense
from syconn_tpu_torch.io import resident
from syconn_tpu_torch.io.chunked import ChunkedVolume as TVolume
from syconn_tpu_torch.models import io as tio
from syconn_tpu_torch.models.unet3d import UNet3D
from syconn_tpu_torch.utils import tracing

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


def _chunk_files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.zst"))}


@pytest.mark.parametrize("route", ["stream", "resident"])
@pytest.mark.parametrize("mode", ["probs", "masks"])
@pytest.mark.parametrize("shape", [(64, 64, 32), (56, 48, 24)])
def test_dense_step_writes_each_chunk_once(tmp_path, monkeypatch, shape, mode, route):
    """``predict_dense_to_kd`` writes every chunk of its targets once (one
    ``chunk.write`` span a chunk): the mag-2 chunk that the 8 tiles' pieces
    make up, and at the clipped size the edge chunks. The targets' files at
    mags 1 and 2 equal those that the same unpacked tiles leave written
    through one by one."""
    model = UNet3D(features=(8, 16), strides=((2, 2, 2),), patch=(2, 2, 2), n_classes=4)
    params = tio.init_model_params(model, 0)
    vol = np.random.default_rng(4).integers(0, 255, shape, dtype=np.uint8)
    src = str(tmp_path / "raw")
    TVolume.create(src, scale=(10, 10, 20), boundary=shape, chunk_shape=(32, 32, 16)).save_raw(vol)
    if route == "resident":
        assert resident.put(src, "raw", vol, device="cpu")
    writes = []
    real = {"raw": TVolume.save_raw, "seg": TVolume.save_seg}

    def recording(channel):
        def save(self, data, offset=(0, 0, 0), mags=(1,), **kw):
            writes.append((self.path, channel, np.array(data), tuple(int(o) for o in offset),
                           tuple(mags), kw))
            return real[channel](self, data, offset, mags, **kw)
        return save

    monkeypatch.setattr(TVolume, "save_raw", recording("raw"))
    monkeypatch.setattr(TVolume, "save_seg", recording("seg"))
    targets = {n: str(tmp_path / n) for n in ("mi", "vc")}
    seg = str(tmp_path / "seg") if mode == "probs" else None
    tracing.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            stats = tdense.predict_dense_to_kd(
                src, targets, model, params, {"mi": 1, "vc": 2}, tile_shape=(32, 32, 16),
                halo=(8, 8, 4), seg_path=seg, mode=mode, show_progress=False, device="cpu",
                io_threads=4)
        recs = [r for r in tracing.records() if r["name"] == "chunk.write"]
    finally:
        tracing.clear()
        resident.clear()
    assert stats["route"] == route
    outs = [*targets.values()] + ([seg] if seg else [])
    keys = [r["attrs"]["key"] for r in recs if r["attrs"]["key"].startswith(tuple(outs))]
    n_files = sum(len(_chunk_files(tmp_path / os.path.basename(p))) for p in outs)
    assert n_files == len(outs) * (8 + 1)
    assert len(keys) == len(set(keys)) == n_files
    assert not any(r["attrs"]["early"] for r in recs)
    assert sorted(r["attrs"]["pieces"] for r in recs) == [1] * 8 * len(outs) + [8] * len(outs)
    for path in outs:
        out = TVolume.open(path)
        ref = TVolume.create(path + "_ref", scale=out.scale, boundary=out.boundary,
                             chunk_shape=out.chunk_shape, codec=out.codec)
        for p, channel, data, offset, mags, kw in writes:
            if p == path:
                real[channel](ref, data, offset, mags, **kw)
        assert _chunk_files(tmp_path / os.path.basename(path + "_ref")) == \
            _chunk_files(tmp_path / os.path.basename(path))
