"""The port's dense-prediction slice against the JAX package on the CPU:
``predict_dense_to_kd`` / ``predict_myelin`` with the packaged weights at
full width, the tile-shrink policy and OOM retry, and the chunk store;
the port's mag-2 pooling from the packed output against the JAX package's
chunk store; and on the port alone, that the dense step writes each target
chunk once.

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


def test_probs_mode_at_mags_1_and_2_matches_jax(tmp_path):
    """At target mags (1, 2) the port pools mag 2 from the packed head output
    (``ops.pool``) and the JAX package on the host, in its chunk store: the
    port's mag-2 maps equal that store's pooling of the port's own mag-1
    maps, and at both mags lie within 2 LSB of the JAX package's."""
    vol = _volume(1)
    jsrc, tsrc = _stores(tmp_path, vol)
    jm, jp = jio.load_model(jio.packaged_model_path("syntype"))
    tm, tp = tio.load_model(tio.packaged_model_path("syntype"))
    chans = {"asym": 1, "sym": 2}
    jpred = jdense.DenseTilePredictor(jm, jp, mode="probs", **TILE)
    jdense.predict_dense_to_kd(jsrc, {k: str(tmp_path / f"j_{k}") for k in chans}, jm, jp, chans,
                               predictor=jpred, target_mags=(1, 2), show_progress=False, **TILE)
    tracing.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            tdense.predict_dense_to_kd(tsrc, {k: str(tmp_path / f"t_{k}") for k in chans}, tm, tp,
                                       chans, target_mags=(1, 2), device="cpu",
                                       show_progress=False, **TILE)
        recs = tracing.records()
    finally:
        tracing.clear()
    assert sum(r["name"] == "dense.pool" for r in recs) == 1  # the probe pools nothing
    half = tuple(s // 2 for s in SHAPE)
    for k in chans:
        got = TVolume.open(str(tmp_path / f"t_{k}"))
        ref = JVolume.open(str(tmp_path / f"j_{k}"))
        pooled = JVolume.create(str(tmp_path / f"p_{k}"), scale=(10, 10, 20), boundary=SHAPE,
                                chunk_shape=(32, 32, 32))
        pooled.save_raw(got.load_raw(size=SHAPE), mags=(2,))
        np.testing.assert_array_equal(got.load_raw(size=half, mag=2),
                                      pooled.load_raw(size=half, mag=2))
        for mag, size in ((1, SHAPE), (2, half)):
            d = np.abs(got.load_raw(size=size, mag=mag).astype(np.int16)
                       - ref.load_raw(size=size, mag=mag).astype(np.int16))
            assert np.mean(d <= 2) >= 0.999, (k, mag, float(np.mean(d <= 2)), int(d.max()))


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


def _packed_world(rng, b, tile, patch, n_classes):
    """Random packed tiles (B, sx, sy, sz, C * pvox) and their voxels (B, C, X, Y, Z)."""
    sp = [t // p for t, p in zip(tile, patch)]
    packed = rng.integers(0, 256, (b, *sp, n_classes * int(np.prod(patch))), dtype=np.uint8)
    vox = packed.reshape(b, *sp, n_classes, *patch).transpose(0, 4, 1, 5, 2, 6, 3, 7)
    return packed, vox.reshape(b, n_classes, *tile)


@pytest.mark.parametrize("patch,extents", [
    ((2, 2, 2), [(32, 32, 16), (31, 13, 11), (0, 0, 0)]),   # full, odd edge, a padding row
    ((4, 4, 2), [(13, 32, 16), (32, 31, 1), (1, 1, 1)]),
    ((1, 1, 1), [(7, 9, 5), (32, 32, 16), (0, 0, 0)]),      # a 2x2x2 block spans patch positions
])
def test_pool_mag2_plain_version_equals_the_chunk_store(tmp_path, patch, extents):
    """``ops.pool.pool_mag2`` on the CPU gives the JAX package's chunk
    store's mean pooling of each cropped tile to mag 2 (float32 mean of the
    edge-padded tile, truncated) byte for byte, zeros outside the crop and
    in padding rows."""
    from syconn_tpu_torch.ops.pool import pool_mag2

    tile, classes = (32, 32, 16), [3, 1]
    packed, vox = _packed_world(np.random.default_rng(7), len(extents), tile, patch, 4)
    got = pool_mag2(torch.from_numpy(packed), extents, patch, 4, classes).numpy()
    assert got.shape == (len(extents), 2, 16, 16, 8)
    for row, e in enumerate(extents):
        h = [-(-x // 2) for x in e]
        for k, c in enumerate(classes):
            want = np.zeros((16, 16, 8), np.uint8)
            if min(e) > 0:
                store = JVolume.create(str(tmp_path / f"s{row}_{k}"), scale=(1, 1, 1),
                                       boundary=tile, chunk_shape=tile)
                store.save_raw(vox[row, c, :e[0], :e[1], :e[2]].copy(), (0, 0, 0), mags=(2,))
                want[:h[0], :h[1], :h[2]] = store.load_raw(size=h, mag=2)
            np.testing.assert_array_equal(got[row, k], want)


def test_pool_mag2_rejects_what_it_does_not_take():
    from syconn_tpu_torch.ops.pool import pool_mag2

    packed = torch.zeros((2, 4, 4, 4, 32), dtype=torch.uint8)
    ext = [(8, 8, 8), (8, 8, 8)]
    with pytest.raises(TypeError):
        pool_mag2(packed.float(), ext, (2, 2, 2), 4)
    with pytest.raises(ValueError, match="contiguous"):
        pool_mag2(packed.transpose(1, 2), ext, (2, 2, 2), 4)
    with pytest.raises(ValueError, match="within the tile"):
        pool_mag2(packed, [(8, 8, 8), (8, 9, 8)], (2, 2, 2), 4)
    with pytest.raises(ValueError, match="classes"):
        pool_mag2(packed, ext, (2, 2, 2), 4, [4])


@pytest.mark.parametrize("shape,patch,batch,mode,seg,route", [
    ((64, 64, 32), (2, 2, 2), 1, "probs", False, "stream"),
    ((63, 45, 27), (2, 2, 2), 3, "probs", True, "stream"),  # odd edges 31/13/11; last batch padded
    ((63, 45, 27), (4, 4, 2), 1, "probs", False, "stream"),
    ((64, 64, 32), (4, 4, 2), 3, "probs", False, "stream"),
    ((63, 45, 27), (2, 2, 2), 3, "masks", False, "stream"),
    ((63, 45, 27), (2, 2, 2), 1, "probs", False, "resident"),
])
def test_dense_step_pools_mag2_on_the_device(tmp_path, shape, patch, batch, mode, seg, route):
    """In probs mode at mags (1, 2) the stream route pools the maps to mag 2
    on the device (``dense.pool``; no ``chunk.downsample`` of a map), and its
    files at both mags equal the host-pooling path's: the unpacked mag-1
    tiles written through with ``save_raw(..., mags=(1, 2))``; the JAX
    package's chunk store, given the same tiles, holds the same maps at both
    mags. Masks and the ``seg`` store keep the chunk store's stride view; the
    resident route pools on the host."""
    model = UNet3D(features=(8, 16), strides=((2, 2, 2),), patch=patch, n_classes=4)
    params = tio.init_model_params(model, 0)
    vol = np.random.default_rng(9).integers(0, 255, shape, dtype=np.uint8)
    src = str(tmp_path / "raw")
    TVolume.create(src, scale=(10, 10, 20), boundary=shape, chunk_shape=(32, 32, 16)).save_raw(vol)
    if route == "resident":
        assert resident.put(src, "raw", vol, device="cpu")
    targets = {n: str(tmp_path / n) for n in ("mi", "sj")}
    tile = np.array((32, 32, 16))
    tracing.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            stats = tdense.predict_dense_to_kd(
                src, targets, model, params, {"mi": 1, "sj": 3}, tile_shape=tuple(tile),
                halo=(8, 8, 4), seg_path=str(tmp_path / "seg") if seg else None, mode=mode,
                batch_size=batch, show_progress=False, device="cpu", io_threads=4)
        recs = tracing.records()
    finally:
        tracing.clear()
        resident.clear()
    assert stats["route"] == route and stats["tiles"] == 8
    offsets = [np.array([x, y, z]) for x in range(0, shape[0], 32) for y in range(0, shape[1], 32)
               for z in range(0, shape[2], 16)]
    for name, path in targets.items():
        out = TVolume.open(path)
        assert out.available_mags == [1, 2]
        ref = TVolume.create(path + "_ref", scale=out.scale, boundary=out.boundary,
                             chunk_shape=out.chunk_shape, codec=out.codec)
        jref = JVolume.create(path + "_jax", scale=out.scale, boundary=out.boundary,
                              chunk_shape=out.chunk_shape)
        m1 = out.load_raw(mag=1)
        for o in offsets:
            hi = np.minimum(o + tile, shape)
            for v in (ref, jref):
                v.save_raw(m1[o[0]:hi[0], o[1]:hi[1], o[2]:hi[2]].copy(), o, mags=(1, 2),
                           downsample="mean" if mode == "probs" else "stride")
        files = _chunk_files(tmp_path / name)
        assert any("/mag2/" in f for f in files)
        assert _chunk_files(tmp_path / (name + "_ref")) == files
        for mag in (1, 2):
            np.testing.assert_array_equal(out.load_raw(mag=mag), jref.load_raw(mag=mag))
    pools = [r for r in recs if r["name"] == "dense.pool"]
    downs = [r for r in recs if r["name"] == "chunk.downsample"]
    if mode == "masks" or route == "resident":
        assert not pools and len(downs) == 2 * 8
        assert {r["attrs"]["mode"] for r in downs} == {"stride" if mode == "masks" else "mean"}
        half = sum(int(np.prod(-(-(np.minimum(o + tile, shape) - o) // 2))) for o in offsets)
        assert sum(r["attrs"]["voxels"] for r in downs) == 2 * half
        return
    assert len(pools) == -(-8 // batch) and sum(r["attrs"]["tiles"] for r in pools) == 8
    half = sum(int(np.prod(-(-(np.minimum(o + tile, shape) - o) // 2))) for o in offsets)
    assert sum(r["attrs"]["voxels"] for r in pools) == 2 * half
    # only the seg store's stride view is left to the chunk store
    assert len(downs) == (8 if seg else 0)
    assert all(r["attrs"]["mode"] == "stride" for r in downs)
    assert sum(r["attrs"]["voxels"] for r in downs) == (half if seg else 0)
