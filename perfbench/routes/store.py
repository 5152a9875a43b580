"""Route ``store``: step 1 from disk to disk, as ``start.py`` runs it.

Set-up draws the volume, writes it once as the ``raw`` channel of a chunk
store at mag 1 (``ChunkedVolume.create`` + ``save_raw``, the deployment
chunk, the store's default codec), and its corner of the traffic's
``warmup_volume`` as a second store, which the warm-up pass (pass 0)
predicts: the same tile and batch shapes in fewer tiles. Each pass empties the decompressed-chunk
cache (so every pass decompresses its chunks, as step 1 does once), removes
the target stores and calls the configuration's step-1 entry of
``exec/exec_dense_prediction.py`` with ``kd_path``, ``target_paths`` and
``model=(model, params)``: ``predict_dense_to_kd`` streams the tiles
(loader threads, dispatch and fetch, host unpack, writer threads) and writes
each mapped class at mags 1 and 2.

The judge reads the target stores back from disk at both mags and compares
every tile with the reference.
"""

from __future__ import annotations

import os
import shutil

import torch

from perfbench.lib import inputs
from perfbench.lib import judge as jd
from perfbench.lib.chunkstore import MissingOutput, bytes_on_disk, read_raw
from perfbench.reference import dense as ref_dense

_DENSE = "syconn_tpu_torch.inference.dense"
_CHUNKED = "syconn_tpu_torch.io.chunked"
SPANS = [
    (f"{_DENSE}:DenseTilePredictor.unpack", "unpack", None),
    (f"{_DENSE}:DenseTilePredictor.fetch_raw", "fetch_raw", None),
    (f"{_DENSE}:DenseTilePredictor._forward_on", "forward_on",
     lambda a, kw: {"batch": int(a[1].shape[0])}),
    (f"{_CHUNKED}:ChunkedVolume.load_raw", "load_raw", None),
    (f"{_CHUNKED}:ChunkedVolume.save_raw", "save_raw", None),
]


def setup(ctx):
    from syconn_tpu_torch.exec import exec_dense_prediction
    from syconn_tpu_torch.io.chunked import ChunkedVolume

    model, params = ctx.family.program_model(ctx.arch, ctx.params, ctx.device)
    vol = inputs.em_volume(ctx.volume, ctx.seed, ctx.device)
    raw = os.path.join(ctx.work, "raw")
    host = vol.cpu().numpy()
    ChunkedVolume.create(raw, scale=ctx.config["scale"], boundary=ctx.volume,
                         chunk_shape=ctx.tile).save_raw(host)
    warm = [min(int(w), v) for w, v in zip(ctx.traffic.get("warmup_volume", ctx.volume),
                                           ctx.volume)]
    warm_raw = raw
    if warm != ctx.volume:
        warm_raw = os.path.join(ctx.work, "warm_raw")
        ChunkedVolume.create(warm_raw, scale=ctx.config["scale"], boundary=warm,
                             chunk_shape=ctx.tile).save_raw(
            host[:warm[0], :warm[1], :warm[2]].copy())
    return dict(model=model, params=params, vol=vol, raw=raw, warm_raw=warm_raw,
                entry=getattr(exec_dense_prediction, ctx.config["step1_entry"]),
                targets={n: os.path.join(ctx.work, n) for n in ctx.mapping}, stats=None)


def run_pass(ctx, state, p: int) -> None:
    from syconn_tpu_torch.io.chunked import clear_chunk_cache

    clear_chunk_cache()
    for path in state["targets"].values():
        shutil.rmtree(path, ignore_errors=True)
    state["stats"] = state["entry"](
        kd_path=state["warm_raw"] if p == 0 else state["raw"],
        target_paths=dict(state["targets"]),
        model=(state["model"], state["params"]), tile_shape=ctx.tile, halo=ctx.halo,
        show_progress=False, device=ctx.device)


def judge(ctx, state, control: bool = False):
    maps = {1: {}, 2: {}}
    missing = []
    written = 0
    for name, path in state["targets"].items():
        for mag in (1, 2):
            try:
                maps[mag][name] = torch.from_numpy(read_raw(path, mag)).to(ctx.device)
            except MissingOutput as e:
                missing.append(f"{name} mag{mag}: {e}")
        written += bytes_on_disk(path)
    shape2 = tuple(-(-s // 2) for s in ctx.volume)
    ref2 = {n: torch.zeros(shape2, dtype=torch.uint8, device=ctx.device) for n in ctx.mapping}
    low2 = {n: torch.zeros_like(ref2[n]) for n in ctx.mapping}

    def keep(off, ext, name, ref_u8, prog_u8):
        o = [x // 2 for x in off]
        for dst, src in ((ref2, ref_u8), (low2, prog_u8)):
            m = ref_dense.mag2_tile(src)
            dst[name][o[0]:o[0] + m.shape[0], o[1]:o[1] + m.shape[1], o[2]:o[2] + m.shape[2]] = m

    def program_tile(off, ext):
        if missing:
            return None
        return {n: m[off[0]:off[0] + ext[0], off[1]:off[1] + ext[1], off[2]:off[2] + ext[2]]
                for n, m in maps[1].items()}

    # every tile: the mag-2 level is compared whole
    offsets = ref_dense.tile_offsets(ctx.volume, ctx.tile)
    t = jd.compare_tiles(ctx.reference, state["vol"], ctx.tile, ctx.halo, ctx.mapping, offsets,
                         program_tile, control=control, keep=keep)
    numbers = t.numbers()
    if control or not missing:
        prog2 = low2 if control else maps[2]
        t2 = jd.Tally()
        t2.add_tile([jd.absdiff(prog2[n], ref2[n]) for n in ctx.mapping])
        numbers.update(t2.numbers("mag2_"))
    stats = state["stats"] or {}
    return dict(numbers=numbers, missing=missing, tile_max=t.tile_max,
                notes={"bytes_written_per_pass": written,
                       "dispatches": stats.get("dispatches")})
