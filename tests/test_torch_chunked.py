"""The port's chunk store under concurrent writers: threads that register a
channel or mag of one fresh store at once each dump its metadata; and the
write-back of ``ChunkedVolume.assembling`` against write-through."""

import json
import sys
import threading

import numpy as np
import pytest

from syconn_tpu_torch.io import chunked
from syconn_tpu_torch.io.chunked import ChunkedVolume


def test_concurrent_first_writes_keep_meta(tmp_path):
    tile = (16, 16, 8)
    data = np.random.default_rng(0).integers(0, 255, (8,) + tile, dtype=np.uint8)
    offsets = [(16 * (i % 2), 16 * (i // 2 % 2), 8 * (i // 4)) for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for run in range(20):
            path = str(tmp_path / f"store{run}")
            cv = ChunkedVolume.create(path, scale=(1, 1, 1), boundary=(32, 32, 16),
                                      chunk_shape=tile, codec="zlib")
            start = threading.Barrier(8)
            errors = []

            def write(i):
                start.wait(timeout=30)
                try:
                    cv.save_raw(data[i], offset=offsets[i], mags=(1, 2))
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(repr(e))

            threads = [threading.Thread(target=write, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert errors == [], (run, errors)
            with open(f"{path}/meta.json") as f:
                meta = json.load(f)
            assert "raw" in meta["channels"] and meta["mags"] == [1, 2], (run, meta)
            assert np.array_equal(ChunkedVolume.open(path).load_raw(offset=offsets[5], size=tile),
                                  data[5])
    finally:
        sys.setswitchinterval(interval)


# --------------------------------------------------------------- assembling
# ``ChunkedVolume.assembling`` against write-through: the same writes leave
# the same files, and inside the context each chunk is written once.

CODECS = ["zlib", "zstd"]
CHUNK = (16, 16, 8)


class _Writes:
    """Counts ``_write_chunk`` calls by chunk file, across threads."""

    def __init__(self, monkeypatch):
        self.by_path = {}
        self._lock = threading.Lock()
        real = ChunkedVolume._write_chunk

        def counting(vol, channel, mag, cix, data):
            with self._lock:
                p = vol._chunk_path(channel, mag, cix)
                self.by_path[p] = self.by_path.get(p, 0) + 1
            return real(vol, channel, mag, cix, data)

        monkeypatch.setattr(ChunkedVolume, "_write_chunk", counting)

    def under(self, root):
        return {p: n for p, n in self.by_path.items() if p.startswith(str(root) + "/")}


def _files(root):
    """Chunk files of a store, relative path -> bytes."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.zst"))}


def _store(path, codec, boundary):
    return ChunkedVolume.create(str(path), scale=(1, 1, 1), boundary=boundary,
                                chunk_shape=CHUNK, codec=codec)


def _save(cv, channel, data, offset, mags=(1, 2)):
    if channel == "raw":
        cv.save_raw(data, offset=offset, mags=mags)
    else:
        cv.save_seg(data, offset=offset, mags=mags)


def _pieces(channel, boundary, seed):
    """One random tile per mag-1 chunk, covering the volume."""
    rng = np.random.default_rng(seed)
    hi = 255 if channel == "raw" else 70000
    offsets = [(x, y, z) for x in range(0, boundary[0], CHUNK[0])
               for y in range(0, boundary[1], CHUNK[1]) for z in range(0, boundary[2], CHUNK[2])]
    return [(rng.integers(0, hi, tuple(min(c, b - o) for c, b, o in zip(CHUNK, boundary, off)))
             .astype(np.uint8 if channel == "raw" else np.uint64), off) for off in offsets]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("channel", ["raw", "seg"])
def test_assembling_writes_each_chunk_once(tmp_path, monkeypatch, codec, channel):
    """8 threads write the 16 tiles of a store with mags (1, 2) in shuffled
    orders: each chunk file is written once, and both mags' files equal a
    write-through store's given the same writes."""
    boundary = (64, 32, 16)  # mag 2: (32, 16, 8), two chunks of 8 pieces each
    pieces = _pieces(channel, boundary, 0)
    ref = _store(tmp_path / "ref", codec, boundary)
    for data, off in pieces:
        _save(ref, channel, data, off)
    writes = _Writes(monkeypatch)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for run in range(3):
            root = tmp_path / f"asm{run}"
            cv = _store(root, codec, boundary)
            order = np.random.default_rng(run).permutation(len(pieces))
            start = threading.Barrier(8)
            errors = []

            def write(k):
                start.wait(timeout=30)
                try:
                    for i in order[k::8]:
                        _save(cv, channel, *pieces[i])
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(repr(e))

            with cv.assembling():
                threads = [threading.Thread(target=write, args=(k,)) for k in range(8)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert errors == [], (run, errors)
            counts = writes.under(root)
            assert len(counts) == 16 + 2 and set(counts.values()) == {1}, (run, counts)
            assert _files(root) == _files(tmp_path / "ref"), run
            load = getattr(ChunkedVolume.open(str(root)), f"load_{channel}")
            for mag in (1, 2):
                np.testing.assert_array_equal(load(mag=mag), getattr(ref, f"load_{channel}")(mag=mag))
    finally:
        sys.setswitchinterval(interval)


@pytest.mark.parametrize("codec", CODECS)
def test_assembling_overlaps_and_boundary(tmp_path, monkeypatch, codec):
    """Pieces that overlap, reach past the volume's end or replace a staged
    chunk whole leave the files write-through leaves; overlaps may write a
    chunk early."""
    boundary = (40, 36, 20)
    rng = np.random.default_rng(1)
    pieces = []
    for _ in range(12):
        size = tuple(int(s) for s in rng.integers(4, 24, 3))
        off = tuple(2 * int(rng.integers(0, (b + 8) // 2)) for b in boundary)
        pieces.append((rng.integers(0, 255, size, dtype=np.uint8), off))
    # a staged chunk that a whole-chunk write then replaces
    pieces += [(rng.integers(0, 255, (4, 4, 4), dtype=np.uint8), (18, 2, 10)),
               (rng.integers(0, 255, CHUNK, dtype=np.uint8), (16, 0, 8))]
    ref = _store(tmp_path / "ref", codec, boundary)
    cv = _store(tmp_path / "asm", codec, boundary)
    for data, off in pieces:
        ref.save_raw(data, offset=off, mags=(1, 2))
    writes = _Writes(monkeypatch)
    with cv.assembling():
        for data, off in pieces:
            cv.save_raw(data, offset=off, mags=(1, 2))
    assert _files(tmp_path / "asm") == _files(tmp_path / "ref")
    assert writes.under(tmp_path / "asm")
    for mag in (1, 2):
        np.testing.assert_array_equal(ChunkedVolume.open(str(tmp_path / "asm")).load_raw(mag=mag),
                                      ref.load_raw(mag=mag))


@pytest.mark.parametrize("codec", CODECS)
def test_assembling_reads_staged_and_writes_on_exit(tmp_path, monkeypatch, codec):
    """A read inside the context sees staged pieces before any file holds
    them; a chunk left incomplete is on disk when the context ends."""
    boundary = (32, 32, 16)
    cv = _store(tmp_path / "asm", codec, boundary)
    piece = np.random.default_rng(2).integers(1, 255, (8, 8, 4), dtype=np.uint8)
    writes = _Writes(monkeypatch)
    chunk = tmp_path / "asm" / "raw" / "mag1" / "c_0_0_0.zst"
    with cv.assembling():
        with cv.assembling():  # re-entrant: the inner end writes nothing
            cv.save_raw(piece, offset=(4, 4, 2))
        assert not chunk.exists() and writes.under(tmp_path / "asm") == {}
        got = cv.load_raw(offset=(0, 0, 0), size=(16, 16, 8))
        np.testing.assert_array_equal(got[4:12, 4:12, 2:6], piece)
        assert np.count_nonzero(got) == np.count_nonzero(piece)
    assert chunk.exists() and writes.under(tmp_path / "asm") == {str(chunk): 1}
    chunked.clear_chunk_cache()
    assert chunked._staged == {} and chunked._st_bytes == 0
    got = ChunkedVolume.open(str(tmp_path / "asm")).load_raw(offset=(4, 4, 2), size=(8, 8, 4))
    np.testing.assert_array_equal(got, piece)


@pytest.mark.parametrize("codec", CODECS)
def test_assembling_budget_writes_early(tmp_path, monkeypatch, codec):
    """A budget of two chunks writes the oldest staged chunks early; the
    files equal write-through's."""
    boundary = (64, 64, 16)
    chunk_bytes = int(np.prod(CHUNK))
    monkeypatch.setenv("SYCONN_TPU_CHUNK_CACHE_GB", repr(2.5 * chunk_bytes / (1 << 30)))
    # quarter pieces, chunk by chunk's quarter: 16 chunks staged at once
    # without the budget
    pieces = []
    rng = np.random.default_rng(3)
    for q in range(4):
        for cx in range(4):
            for cy in range(4):
                off = (16 * cx + 8 * (q % 2), 16 * cy + 8 * (q // 2), 0)
                pieces.append((rng.integers(0, 255, (8, 8, 8), dtype=np.uint8), off))
    ref = _store(tmp_path / "ref", codec, boundary)
    for data, off in pieces:
        ref.save_raw(data, offset=off, mags=(1,))
    writes = _Writes(monkeypatch)
    cv = _store(tmp_path / "asm", codec, boundary)
    with cv.assembling():
        for data, off in pieces:
            cv.save_raw(data, offset=off, mags=(1,))
            assert chunked._st_bytes <= 2.5 * chunk_bytes
    counts = writes.under(tmp_path / "asm")
    assert len(counts) == 16 and sum(counts.values()) > 16
    assert _files(tmp_path / "asm") == _files(tmp_path / "ref")


@pytest.mark.parametrize("codec", CODECS)
def test_assembling_exception_writes_staged(tmp_path, codec):
    """An exception inside the context leaves every staged piece on disk."""
    boundary = (32, 32, 16)
    cv = _store(tmp_path / "asm", codec, boundary)
    pieces = _pieces("raw", boundary, 4)
    with pytest.raises(RuntimeError, match="stop"):
        with cv.assembling():
            for data, off in pieces:
                cv.save_raw(data, offset=off, mags=(1, 2))
            raise RuntimeError("stop")
    assert chunked._staged == {}
    chunked.clear_chunk_cache()
    back = ChunkedVolume.open(str(tmp_path / "asm"))
    for data, off in pieces:
        np.testing.assert_array_equal(back.load_raw(offset=off, size=data.shape), data)
    assert (tmp_path / "asm" / "raw" / "mag2" / "c_0_0_0.zst").exists()


@pytest.mark.parametrize("codec", CODECS)
def test_save_outside_assembling_writes_through(tmp_path, monkeypatch, codec):
    """Outside any context every ``save_raw`` writes each chunk it touches
    before it returns: another volume object reads the data at once."""
    boundary = (32, 32, 16)
    cv = _store(tmp_path / "wt", codec, boundary)
    writes = _Writes(monkeypatch)
    for i, (data, off) in enumerate(_pieces("raw", boundary, 5)):
        cv.save_raw(data, offset=off, mags=(1, 2))
        # this tile's mag-1 chunk, and the one mag-2 chunk once more
        assert sum(writes.under(tmp_path / "wt").values()) == 2 * (i + 1)
        assert chunked._staged == {}
        chunked.clear_chunk_cache()
        other = ChunkedVolume.open(str(tmp_path / "wt"))
        np.testing.assert_array_equal(other.load_raw(offset=off, size=data.shape), data)
        o2 = tuple(o // 2 for o in off)
        assert other.load_raw(offset=o2, size=(8, 8, 4), mag=2).shape == (8, 8, 4)
