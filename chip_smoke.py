#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``syconn_tpu_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
one CUDA card (Hopper: the kernels are built for sm_90a at first use).

Phases, each failing the run on error:
  1. card name and power limit, versions, kernel build time;
  2. every conv kernel against its plain PyTorch version at every shape of
     the dense-prediction main path (syntype tile (256, 256, 128) + halo
     (32, 32, 16) -> patched (80, 80, 80)), with kernel, plain-version and
     library (cuDNN, no epilogue) times and the roofline bound;
  3. the slice: ``predict_synapsetype`` (probs) and ``predict_myelin``
     (masks) over a seeded 512x512x256 volume in the port's chunk store,
     checking that every kernel of the path was launched the expected
     number of times, that the outputs are well-formed, and that the
     kernel path agrees with the plain CPU path on a small input.

The line before last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Exits non-zero without a result
when CUDA is unavailable or the package is missing.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SOURCE = "syconn_tpu_torch/ops/csrc/conv3d.cu"
REPLACES = {
    "conv3x3x3_ln_gelu": "syconn_tpu/ops/conv3d_pallas.py:70",
    "conv_down2x_bias": "syconn_tpu/ops/conv3d_pallas.py:393",
    "conv_transpose2x_bias": "syconn_tpu/ops/conv3d_pallas.py:261",
}
# (kernel, spatial edge, cin, cout, head width, epilogue, launches per syntype tile)
SHAPES = [
    ("conv3x3x3_ln_gelu", 80, 32, 64, 0, "ln_gelu", 1),
    ("conv3x3x3_ln_gelu", 80, 64, 64, 0, "ln_gelu", 1),
    ("conv3x3x3_ln_gelu", 80, 128, 64, 0, "ln_gelu", 1),
    ("conv3x3x3_ln_gelu", 80, 64, 64, 96, "ln_gelu", 1),
    ("conv3x3x3_ln_gelu", 40, 128, 128, 0, "ln_gelu", 3),
    ("conv3x3x3_ln_gelu", 40, 256, 128, 0, "ln_gelu", 1),
    ("conv3x3x3_ln_gelu", 20, 256, 256, 0, "ln_gelu", 2),
    ("conv3x3x3_ln_gelu", 80, 64, 64, 64, "ln_gelu", 0),   # myelin head
    ("conv3x3x3_ln_gelu", 40, 256, 128, 0, "bias", 0),     # up_phases=False form
    ("conv_down2x_bias", 80, 64, 128, 0, "bias", 1),
    ("conv_down2x_bias", 40, 128, 256, 0, "bias", 1),
    ("conv_transpose2x_bias", 20, 256, 128, 0, "bias", 1),
    ("conv_transpose2x_bias", 40, 128, 64, 0, "bias", 1),
]
PER_TILE = {"syntype": {"conv3x3x3_ln_gelu": 10, "conv_down2x_bias": 2, "conv_transpose2x_bias": 2},
            "myelin": {"conv3x3x3_ln_gelu": 6, "conv_down2x_bias": 1, "conv_transpose2x_bias": 1}}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 2, reps: int = 7) -> float:
    """Median of ``reps`` single-call CUDA-event timings after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def rel_check(got, ref, what: str, floor: float = 1e-2):
    """bf16-resolution agreement (the tolerance of tests/test_conv_pallas.py):
    median relative error < 2e-2 and < 2% of elements off by > 10%."""
    import torch

    g = got.float()
    r = ref.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    rel = (g - r).abs() / r.abs().clamp_min(floor)
    med = float(rel.median())
    frac = float((rel > 0.1).float().mean())
    if med >= 2e-2 or frac >= 2e-2:
        raise AssertionError(f"{what}: median rel {med:.3g}, frac(rel>0.1) {frac:.3g}")
    return float((g - r).abs().max()), med, frac


def phase_kernels(dev):
    """Phase 2: kernel vs plain version (and library) at main-path shapes."""
    import torch
    import torch.nn.functional as F

    from syconn_tpu_torch.ops import conv3d as C

    gen = torch.Generator().manual_seed(0)
    rows = []
    for name, n, cin, cout, nh, epi, per_tile in SHAPES:
        up = name == "conv_transpose2x_bias"
        x = torch.randn((1, n, n, n, cin), generator=gen).to(dev, torch.bfloat16)
        w = (torch.randn((27, cin, cout), generator=gen) / (27 * cin) ** 0.5).to(dev, torch.bfloat16)
        b = (0.1 * torch.randn((cout,), generator=gen)).to(dev, torch.bfloat16)
        g = (1 + 0.1 * torch.randn((cout,), generator=gen)).to(dev)
        beta = (0.1 * torch.randn((cout,), generator=gen)).to(dev)
        hw = hb = None
        if nh:
            hw = (torch.randn((cout, nh), generator=gen) / cout ** 0.5).to(dev)
            hb = (0.1 * torch.randn((nh,), generator=gen)).to(dev)
        if name == "conv3x3x3_ln_gelu":
            def kern():
                return C.conv3x3x3_ln_gelu(x, w, b, g, beta, epilogue=epi, head_w=hw, head_b=hb)

            def plain():
                return C.conv3x3x3_ln_gelu_ref(x, w, b, g, beta, epilogue=epi, head_w=hw, head_b=hb)
            s_out = n ** 3
            flops = 2 * 27 * s_out * cin * cout + 2 * s_out * cout * nh
            out_bytes = s_out * (4 * nh if nh else 2 * cout)
            lib_args = dict(stride=1, padding=1)
        elif name == "conv_down2x_bias":
            def kern():
                return C.conv_down2x_bias(x, w, b)

            def plain():
                return C.conv_down2x_bias_ref(x, w, b)
            s_out = (n // 2) ** 3
            flops = 2 * 27 * s_out * cin * cout
            out_bytes = s_out * 2 * cout
            lib_args = dict(stride=2, padding=1)
        else:
            def kern():
                return C.conv_transpose2x_bias(x, w, b)

            def plain():
                return C.conv_transpose2x_bias_ref(x, w, b)
            flops = 2 * 27 * n ** 3 * cin * cout
            out_bytes = (2 * n) ** 3 * 2 * cout
            lib_args = None
        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        max_err, med, frac = rel_check(got, ref, f"{name} {n}^3 {cin}->{cout} nh={nh} {epi}")
        del got, ref
        in_bytes = x.numel() * 2 + w.numel() * 2 + cout * 2 + (cout * nh * 4 if nh else 0)
        bound_f = flops / PEAK_FLOPS * 1e3
        bound_b = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
        k_ms = cuda_ms(kern)
        p_ms = cuda_ms(plain, warmup=1, reps=5)
        # library yardstick: cuDNN bf16 channels-last conv of the same shape
        # and cost, without the fused epilogue; timed only, never used
        xc = x.permute(0, 4, 1, 2, 3)
        wl = w.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        if up:
            wt = w.reshape(3, 3, 3, cin, cout).permute(3, 4, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            l_ms = cuda_ms(lambda: F.conv_transpose3d(xc, wt, stride=2, padding=1, output_padding=1))
        else:
            l_ms = cuda_ms(lambda: F.conv3d(xc, wl, **lib_args))
        row = dict(name=name, n=n, cin=cin, cout=cout, nh=nh, epilogue=epi, per_tile=per_tile,
                   max_abs_err=max_err, median_rel=med, frac_rel_gt_0p1=frac,
                   kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                   bound_ms=max(bound_f, bound_b), bound_by="operations" if bound_f >= bound_b else "bytes",
                   tflops=flops / k_ms / 1e9)
        rows.append(row)
        log("kernel " + json.dumps(row))
        del x, w
        torch.cuda.empty_cache()
    return rows


def make_volume(path: str, shape, seed: int = 0):
    """Seeded EM-like uint8 volume (smoothed noise) in the port's store."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from syconn_tpu_torch.io.chunked import ChunkedVolume

    g = torch.Generator(device="cuda").manual_seed(seed)
    v = torch.randn((1, 1) + tuple(shape), generator=g, device="cuda")
    v = F.avg_pool3d(v, 5, stride=1, padding=2)
    v = (128 + 40 * v / v.std()).clamp(0, 255).to(torch.uint8)
    vol = v[0, 0].cpu().numpy()
    cv = ChunkedVolume.create(path, scale=(10, 10, 20), boundary=shape,
                              chunk_shape=(256, 256, 256))
    cv.save_raw(vol)
    return np.ascontiguousarray(vol)


def phase_forward(dev, task: str):
    """Device time of one tile's forward (engine + softmax/threshold, no
    host IO): CUDA events, and the profiler's per-kernel device time."""
    import torch

    from syconn_tpu_torch.inference.dense import DenseTilePredictor
    from syconn_tpu_torch.models.io import load_model, load_model_meta, packaged_model_path
    from syconn_tpu_torch.models.unet_engine import unet_flops

    model, params = load_model(packaged_model_path(task))
    thr = load_model_meta(packaged_model_path(task)).get("threshold")
    pred = DenseTilePredictor(model, params, tile_shape=(256, 256, 128), halo=(32, 32, 16),
                              mode="probs" if thr is None else "masks", device=dev)
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randint(0, 256, pred._in_shape, generator=g, device="cuda", dtype=torch.uint8)
    ms = cuda_ms(lambda: pred._forward(x), warmup=2, reps=5)
    flops = unet_flops(model, pred._in_shape)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        pred._forward(x)
        torch.cuda.synchronize()
    top = []
    for e in sorted(prof.key_averages(), key=lambda e: -getattr(e, "device_time_total", 0.0))[:8]:
        top.append((e.key[:60], round(getattr(e, "device_time_total", 0.0) / 1e3, 4), e.count))
    res = dict(task=task, forward_ms=ms, tile_mvox_per_s=256 * 256 * 128 / ms / 1e3,
               forward_tflops=flops / ms / 1e9, flops=flops, profile_device_ms=top)
    log(f"forward {json.dumps(res)}")
    return res


def phase_slice(dev, work: str):
    """Phase 3: the dense-prediction slice on the card."""
    import numpy as np
    import torch

    from syconn_tpu_torch.exec.exec_dense_prediction import predict_myelin, predict_synapsetype
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.ops.conv3d import LAUNCHES, reset_launch_counts

    shape = (512, 512, 256)
    t0 = time.perf_counter()
    kd = os.path.join(work, "raw")
    make_volume(kd, shape)
    log(f"slice volume {shape} written in {time.perf_counter() - t0:.3f} s")
    results = {}
    launches = {k: 0 for k in LAUNCHES}
    for task in ("syntype", "myelin"):
        targets = ({"asym": os.path.join(work, "asym"), "sym": os.path.join(work, "sym")}
                   if task == "syntype" else {"myelin": os.path.join(work, "myelin")})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        if task == "syntype":
            stats = predict_synapsetype(kd, targets, tile_shape=(256, 256, 128), halo=(32, 32, 16),
                                        device=dev, show_progress=False)
        else:
            stats = predict_myelin(kd, targets, tile_shape=(256, 256, 128), halo=(32, 32, 16),
                                   device=dev, show_progress=False)
        counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        for k, per in PER_TILE[task].items():
            want = stats["dispatches"] * per
            if counts[k] <= 0 or counts[k] != want:
                raise AssertionError(f"{task}: {k} launched {counts[k]} times, expected "
                                     f"{stats['dispatches']} dispatches x {per}")
            launches[k] += counts[k]
        name = next(iter(targets))
        out = ChunkedVolume.open(targets[name]).load_raw(size=shape)
        if out.shape != shape or int(out.max()) == int(out.min()):
            raise AssertionError(f"{task}: output {name} has shape {out.shape}, "
                                 f"range [{out.min()}, {out.max()}]")
        if task == "myelin" and not set(np.unique(out).tolist()) <= {0, 255}:
            raise AssertionError("myelin masks are not 0/255")
        res = dict(stats, peak_bytes=int(peak), launches=counts,
                   mean_out=float(out.mean()), output=name)
        results[task] = res
        log(f"slice {task} " + json.dumps(res))
    return results, launches


def phase_reference(dev):
    """Kernel path against the plain CPU path of the same predictor on a
    small input: uint8 probabilities within 2 LSB on >= 99.9% of voxels."""
    import numpy as np

    from syconn_tpu_torch.inference.dense import DenseTilePredictor
    from syconn_tpu_torch.models.io import load_model, packaged_model_path

    model, params = load_model(packaged_model_path("syntype"))
    rng = np.random.default_rng(1)
    vol = rng.integers(0, 256, (64, 64, 32), dtype=np.uint8)
    kw = dict(tile_shape=(64, 64, 32), halo=(8, 8, 4), mode="probs")
    got = DenseTilePredictor(model, params, device=dev, **kw).predict_array(vol)
    ref = DenseTilePredictor(model, params, device="cpu", **kw).predict_array(vol)
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    ok = float(np.mean(d <= 2))
    log(f"reference syntype probs: max |diff| {int(d.max())} LSB, within 2 LSB {ok:.6f}")
    if ok < 0.999:
        raise AssertionError(f"kernel path vs plain CPU path: only {ok:.5f} within 2 LSB")
    return ok


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "syconn_tpu_torch")):
        print("chip_smoke: run from a checkout holding syconn_tpu_torch", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from syconn_tpu_torch.ops import build
    from syconn_tpu_torch.utils.device import default_device

    dev = default_device()
    card = smi()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.build_all()
    log(f"kernel build {time.perf_counter() - t0:.3f} s ({build.BUILD_SECONDS})")
    for line in build.ptxas_log("conv3d").splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas " + line.strip())

    rows = phase_kernels(dev)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_reference(dev)
        fwd = {t: phase_forward(dev, t) for t in ("syntype", "myelin")}
        results, launches = phase_slice(dev, work)
        for t, r in results.items():
            busy = r["dispatches"] * fwd[t]["forward_ms"] / (r["seconds"] * 1e3)
            log(f"slice {t}: {r['mvox_per_s']:.3f} MVx/s end to end, forward alone "
                f"{fwd[t]['tile_mvox_per_s']:.3f} MVx/s; device busy ~{busy:.4f} of the wall "
                f"(dispatches x forward_ms / seconds)")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = []
    for name in REPLACES:
        rs = [r for r in rows if r["name"] == name and r["per_tile"] > 0]
        per_tile = lambda key: sum(r[key] * r["per_tile"] for r in rs)  # noqa: E731
        bf = sum(r["bound_ms"] * r["per_tile"] for r in rs if r["bound_by"] == "operations")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows if r["name"] == name),
            ms=per_tile("kernel_ms"), plain_ms=per_tile("plain_ms"),
            bound_ms=per_tile("bound_ms"),
            bound_by="operations" if bf >= 0.5 * per_tile("bound_ms") else "bytes",
            library_ms=per_tile("library_ms")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
