#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``syconn_tpu_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
one CUDA card (Hopper: the kernels are built for sm_90a at first use).

Phases, each failing the run on error:
  1. card name and power limit, versions, kernel build time, and per kernel
     the registers, spills and barriers ptxas reports (the wgmma kernels use
     barrier 0 only, once, after the mbarrier init; the SAME, stride-2 and
     transpose instantiations must all be there, and a ptxas note that it
     serialised the wgmmas fails the run);
  2. every conv kernel against its plain PyTorch version at every shape of
     the dense-prediction main path (syntype tile (256, 256, 128) + halo
     (32, 32, 16) -> patched (80, 80, 80)), with kernel, plain-version and
     library (cuDNN, no epilogue) times and the roofline bound, and at the
     shapes the wgmma kernels' tiling could get wrong (ragged extents, batch
     2, every Cout, odd transpose extents, the stride-2 conv's ragged even
     extents and Cout split, the head that falls to the mma.sync kernel);
  3. the slice: ``predict_synapsetype`` (probs) and ``predict_myelin``
     (masks) over a seeded 512x512x256 volume in the port's chunk store,
     checking that every kernel of the path was launched the expected
     number of times, that the outputs are well-formed, and that the
     kernel path agrees with the plain CPU path on a small input;
  4. the contact kernel against its plain version (all integers: equal) at
     the deployment chunk (256, 256, 128) + halo (6, 6, 3), tile (32, 32),
     K = 32, stencil (13, 13, 7), at an awkward shape with overflowing
     columns, and at the deployment shape on dense labels (~22 live
     candidates a column);
  5. the contact slice: ``run_contact_extraction`` over a seeded
     512x512x256 label volume, streaming (``CsDispatcher``, the CUDA kernel)
     and from the device-resident store; kernel launches equal the chunks,
     the two runs' label volumes and counts are equal, and a small two-cube
     volume agrees between the card and the CPU path.

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
# int32 outside the tensor cores: 132 SMs x 64 int32 lanes x 1.98 GHz boost,
# one operation per lane and clock (half the lanes of the 67 TFLOP/s float32
# figure, which counts a fused multiply-add as two)
PEAK_INT32 = 16.7e12
# integer operations of one candidate step per output voxel in the leanest
# packed separable form: the indicator and the running z and x sums (an add
# and a subtract each) on four byte lanes per 32-bit operation, (1 + 2 + 2) / 4;
# the running y sum, the key (shift, or), the own-slot mask and the max on two
# 16-bit lanes, (2 + 2 + 1 + 1) / 2
CANDIDATE_STEP_OPS = 4.25
SOURCES = {
    "conv3x3x3_ln_gelu": "syconn_tpu_torch/ops/csrc/conv3d_wgmma.cu",
    "conv_down2x_bias": "syconn_tpu_torch/ops/csrc/conv3d_wgmma.cu",
    "conv_transpose2x_bias": "syconn_tpu_torch/ops/csrc/conv3d_wgmma.cu",
}
CONTACT_SOURCE = "syconn_tpu_torch/ops/csrc/contacts.cu"
CONTACT_REPLACES = "syconn_tpu/ops/contacts_pallas.py:45"
# (label, seg shape incl. halo, stencil, tile_xy, K, label block, on the main path)
CONTACT_SHAPES = [
    ("deployment", (268, 268, 134), (13, 13, 7), (32, 32), 32, (48, 48, 96), True),
    ("awkward", (200, 136, 72), (5, 5, 3), (32, 32), 8, (24, 24, 36), False),
    # deployment stencil, tile and K on labels dense enough for ~22 live
    # candidates per column (2 of 64 columns overflow)
    ("dense", (268, 268, 134), (13, 13, 7), (32, 32), 32, (24, 24, 40), False),
]
REPLACES = {
    "conv3x3x3_ln_gelu": "syconn_tpu/ops/conv3d_pallas.py:70",
    "conv_down2x_bias": "syconn_tpu/ops/conv3d_pallas.py:393",
    "conv_transpose2x_bias": "syconn_tpu/ops/conv3d_pallas.py:261",
}
# (kernel, spatial edge or (B, X, Y, Z), cin, cout, head width, epilogue,
#  launches per syntype tile)
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
    # off the main path: what only the brick tiling of the wgmma kernels can get wrong
    ("conv3x3x3_ln_gelu", (1, 21, 13, 7), 64, 64, 0, "ln_gelu", 0),     # ragged
    ("conv3x3x3_ln_gelu", (2, 24, 20, 12), 64, 64, 96, "ln_gelu", 0),   # batch 2, head
    ("conv3x3x3_ln_gelu", (1, 40, 40, 40), 64, 32, 0, "ln_gelu", 0),    # Cout 32
    ("conv3x3x3_ln_gelu", (1, 21, 20, 19), 40, 256, 0, "ln_gelu", 0),   # Cout 256, Cin % 32 != 0
    ("conv3x3x3_ln_gelu", (1, 12, 12, 12), 32, 256, 96, "ln_gelu", 0),  # head on the mma.sync kernel
    ("conv_transpose2x_bias", (2, 11, 9, 13), 128, 64, 0, "bias", 0),   # odd extents, batch 2
    ("conv_down2x_bias", (1, 22, 14, 10), 64, 128, 0, "bias", 0),       # ragged even extents
    ("conv_down2x_bias", (2, 16, 12, 20), 32, 64, 0, "bias", 0),        # batch 2
    ("conv_down2x_bias", (1, 20, 18, 16), 64, 32, 0, "bias", 0),        # Cout 32
    ("conv_down2x_bias", (1, 22, 14, 10), 40, 256, 0, "bias", 0),       # Cout 256 split, Cin 40
]
MODES = {"conv3x3x3_ln_gelu": "same", "conv_down2x_bias": "down", "conv_transpose2x_bias": "up"}
PER_TILE = {"syntype": {"conv3x3x3_ln_gelu": 10, "conv_down2x_bias": 2, "conv_transpose2x_bias": 2},
            "myelin": {"conv3x3x3_ln_gelu": 6, "conv_down2x_bias": 1, "conv_transpose2x_bias": 1}}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 2, reps: int = 7, inner: int = 8) -> float:
    """Device time of one call: median over ``reps`` CUDA-event timings of
    ``inner`` calls enqueued back to back (so that the host's time to launch
    a call hides behind the card's work on the one before), after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        fn()  # the card is busy when the first event is recorded
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
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
        dims = (1, n, n, n) if isinstance(n, int) else tuple(n)
        vox = dims[0] * dims[1] * dims[2] * dims[3]
        x = torch.randn(dims + (cin,), generator=gen).to(dev, torch.bfloat16)
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
            s_out = vox
            flops = 2 * 27 * s_out * cin * cout + 2 * s_out * cout * nh
            out_bytes = s_out * (4 * nh if nh else 2 * cout)
            lib_args = dict(stride=1, padding=1)
        elif name == "conv_down2x_bias":
            def kern():
                return C.conv_down2x_bias(x, w, b)

            def plain():
                return C.conv_down2x_bias_ref(x, w, b)
            s_out = vox // 8
            flops = 2 * 27 * s_out * cin * cout
            out_bytes = s_out * 2 * cout
            lib_args = dict(stride=2, padding=1)
        else:
            def kern():
                return C.conv_transpose2x_bias(x, w, b)

            def plain():
                return C.conv_transpose2x_bias_ref(x, w, b)
            flops = 2 * 27 * vox * cin * cout
            out_bytes = 8 * vox * 2 * cout
            lib_args = None
        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        max_err, med, frac = rel_check(got, ref, f"{name} {dims} {cin}->{cout} nh={nh} {epi}")
        del got, ref
        in_bytes = x.numel() * 2 + w.numel() * 2 + cout * 2 + (cout * nh * 4 if nh else 0)
        bound_f = flops / PEAK_FLOPS * 1e3
        bound_b = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
        k_ms = cuda_ms(kern)
        p_ms = cuda_ms(plain, warmup=1, reps=3, inner=2)
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
        plan = C.tile_plan(MODES[name], cin, cout, nh)
        if (per_tile > 0 or name != "conv3x3x3_ln_gelu") and plan is None:
            raise AssertionError(f"{name} {dims} {cin}->{cout} nh={nh}: a main-path shape, and "
                                 f"every stride-2 or transposed conv, must take the wgmma kernel")
        row = dict(name=name, n=n, cin=cin, cout=cout, nh=nh, epilogue=epi, per_tile=per_tile,
                   kernel="mma.sync" if plan is None else "wgmma",
                   smem_bytes=None if plan is None else plan["smem_bytes"],
                   max_abs_err=max_err, median_rel=med, frac_rel_gt_0p1=frac,
                   kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                   bound_ms=max(bound_f, bound_b), bound_by="operations" if bound_f >= bound_b else "bytes",
                   tflops=flops / k_ms / 1e9)
        rows.append(row)
        log("kernel " + json.dumps(row))
        del x, w
        torch.cuda.empty_cache()
    return rows


def phase_repack(dev):
    """Cost of the wrappers' one-time weight repack (K-major stage images, the
    head's three bf16 parts) for the packaged syntype model, on the card."""
    import torch

    from syconn_tpu_torch.models.convert import kernel_taps
    from syconn_tpu_torch.models.io import load_model, packaged_model_path
    from syconn_tpu_torch.ops import conv3d as C

    _, params = load_model(packaged_model_path("syntype"))
    convs, head = [], None

    def walk(tree):
        nonlocal head
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val)
            elif key == "kernel" and tuple(val.shape[:3]) == (3, 3, 3):
                convs.append(kernel_taps(val).to(dev))
            elif key == "kernel":
                head = torch.as_tensor(val).reshape(val.shape[-2], val.shape[-1]).float().to(dev)

    walk(params)

    def repack():
        for w in convs:
            C.pack_conv_weight(w)
        C.pack_head(head)

    ms = cuda_ms(repack, warmup=1, reps=3, inner=2)
    log("repack " + json.dumps(dict(model="syntype", conv_weights=len(convs), head=list(head.shape),
                                   ms=ms, bytes=sum(w.numel() * 2 for w in convs))))
    return ms


def blocky_labels(shape, block, seed: int, hot=None):
    """Seeded label volume (numpy uint64): blocks of ``block`` voxels with
    ids drawn without replacement below 2**24, a fifth of them background;
    ``hot`` = (offset, size) fills a region with 4x4x4 blocks of 64 further
    ids, so that the columns through it overflow the candidate table."""
    import numpy as np

    rng = np.random.default_rng(seed)
    grid = tuple(-(-s // b) for s, b in zip(shape, block))
    ids = rng.choice(2**24 - 1, size=int(np.prod(grid)) + 64, replace=False).astype(np.uint64) + 1
    field = ids[:-64].reshape(grid).copy()
    field[rng.random(grid) < 0.2] = 0
    vol = field
    for ax, b in enumerate(block):
        vol = np.repeat(vol, b, axis=ax)
    vol = np.ascontiguousarray(vol[:shape[0], :shape[1], :shape[2]])
    if hot is not None:
        off, size = hot
        small = ids[-64:][rng.integers(0, 64, tuple(-(-s // 4) for s in size))]
        for ax in range(3):
            small = np.repeat(small, 4, axis=ax)
        vol[off[0]:off[0] + size[0], off[1]:off[1] + size[1], off[2]:off[2] + size[2]] = \
            small[:size[0], :size[1], :size[2]]
    return vol


def phase_contact_kernels(dev, shapes=None):
    """Phase 4: the contact kernel against its plain version, exactly."""
    import numpy as np
    import torch

    from syconn_tpu_torch.ops import contacts_cuda as CC

    int_max = np.iinfo(np.int32).max
    rows = []
    for label, shape, stencil, tile_xy, K, block, main in shapes or CONTACT_SHAPES:
        seg = blocky_labels(shape, block, seed=11)
        seg_p, offs, cands, overflow, _ = CC._columns_prep(seg, stencil, tile_xy, K)
        args = [torch.from_numpy(a).to(dev) for a in (seg_p, offs, cands)]
        lo, hi = CC.detect_cs_columns(*args, stencil, tile_xy)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        lo_p, hi_p = CC.detect_cs_columns_ref(*args, stencil, tile_xy)
        err = max(int((lo.long() - lo_p.long()).abs().max()), int((hi.long() - hi_p.long()).abs().max()))
        if err != 0 or not bool(lo.any()):
            raise AssertionError(f"contact kernel {label}: max |diff| {err} against the plain "
                                 f"version, any output {bool(lo.any())}")
        del lo_p, hi_p
        live = (cands != int_max).sum(axis=1)
        n_out = int(np.prod(lo.shape))
        ops = int(lo.shape[1] * lo.shape[2] * lo.shape[3] * int(live.sum())) * CANDIDATE_STEP_OPS
        nbytes = seg_p.nbytes + 2 * 4 * n_out
        bound_o = ops / PEAK_INT32 * 1e3
        bound_b = nbytes / PEAK_BYTES * 1e3
        k_ms = cuda_ms(lambda: CC.detect_cs_columns(*args, stencil, tile_xy))
        p_ms = cuda_ms(lambda: CC.detect_cs_columns_ref(*args, stencil, tile_xy), warmup=1, reps=3, inner=1)
        row = dict(name="detect_cs_columns", shape=label, seg=list(shape), stencil=list(stencil),
                   tile_xy=list(tile_xy), K=K, columns=len(offs), main_path=main,
                   overflow_columns=int(overflow.sum()),
                   live_candidates_per_column=float(live.mean()),
                   max_abs_err=err, kernel_ms=k_ms, plain_ms=p_ms, library_ms=None,
                   library_note="no single PyTorch call computes this function",
                   bound_ms=max(bound_o, bound_b),
                   bound_by="operations" if bound_o >= bound_b else "bytes",
                   bound_bytes=nbytes, bound_int_ops=ops,
                   int32_ops_per_s=PEAK_INT32, ops_per_candidate_step=CANDIDATE_STEP_OPS,
                   gvox_candidates_per_s=ops / CANDIDATE_STEP_OPS / k_ms / 1e6)
        rows.append(row)
        log("kernel " + json.dumps(row))
        del lo, hi, args
    return rows


def make_volume(path: str, shape, seed: int = 0, mean: float = 128.0, std: float = 40.0):
    """Seeded EM-like uint8 volume (smoothed noise) in the port's store."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from syconn_tpu_torch.io.chunked import ChunkedVolume

    g = torch.Generator(device="cuda").manual_seed(seed)
    v = torch.randn((1, 1) + tuple(shape), generator=g, device="cuda")
    v = F.avg_pool3d(v, 5, stride=1, padding=2)
    v = (mean + std * v / v.std()).clamp(0, 255).to(torch.uint8)
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
    ms = cuda_ms(lambda: pred._forward(x), warmup=2, reps=5, inner=4)
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


def _load_labels(out_dir: str, shape):
    from syconn_tpu_torch.io.chunked import ChunkedVolume

    return {n: ChunkedVolume.open(os.path.join(out_dir, f"{n}_seg")).load_seg(size=shape)
            for n in ("cs", "syn")}


def phase_slice_contacts(dev, work: str, sym_path=None, asym_path=None,
                         shape=(512, 512, 256), chunk=(256, 256, 128)):
    """Phase 5: contact-site extraction on the card, streaming through the
    CUDA kernel and from the device-resident store."""
    import numpy as np
    import torch

    from syconn_tpu_torch.exec.exec_syns import run_contact_extraction
    from syconn_tpu_torch.io import resident
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.ops.conv3d import LAUNCHES, reset_launch_counts

    t0 = time.perf_counter()
    hot = (tuple(s // 5 for s in shape), tuple(max(8, s // 12) for s in shape))
    seg = blocky_labels(shape, (48, 48, 96), seed=7, hot=hot)
    seg_path = os.path.join(work, "sv_seg")
    ChunkedVolume.create(seg_path, scale=(10, 10, 20), boundary=shape,
                         chunk_shape=(256, 256, 256)).save_seg(seg)
    sj_path = os.path.join(work, "sj")
    # ~a quarter of the voxels reach the sj threshold of 0.19 * 255
    make_volume(sj_path, shape, seed=5, mean=20.0, std=40.0)
    log(f"slice contacts volumes {shape} written in {time.perf_counter() - t0:.3f} s")
    n_chunks = int(np.prod([-(-s // c) for s, c in zip(shape, chunk)]))
    runs = {}
    for mode in ("stream", "resident"):
        out_dir = os.path.join(work, f"contacts_{mode}")
        if mode == "resident" and not resident.put(seg_path, "seg", seg, device=dev):
            raise AssertionError("the resident store refused the segmentation")
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        res = run_contact_extraction(seg_path, out_dir, kd_sj_path=sj_path, kd_sym_path=sym_path,
                                     kd_asym_path=asym_path, chunk_size=chunk, overwrite=True,
                                     device=dev)
        counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        resident.clear()
        st = res["stats"]
        if st["path"] != mode or st["dispatched"] != n_chunks or (
                mode == "stream" and st["host_chunks"] != 0):
            raise AssertionError(f"contacts {mode}: took path {st['path']}, dispatched "
                                 f"{st['dispatched']} of {n_chunks} chunks, host {st['host_chunks']}")
        if mode == "stream" and dev.type == "cuda" and not (
                counts["detect_cs_columns"] == st["dispatched"] > 0):
            raise AssertionError(f"contacts stream: kernel launched {counts['detect_cs_columns']} "
                                 f"times for {st['dispatched']} dispatched chunks")
        line = dict(st, n_cs=res["n_cs"], n_syn=res["n_syn"], peak_bytes=int(peak),
                    launches=counts["detect_cs_columns"],
                    mvox_per_s=float(np.prod(shape)) / st["seconds"] / 1e6,
                    overflow_share=st["overflow_columns"] / max(1, st["columns"]))
        runs[mode] = (res, _load_labels(out_dir, shape), line)
        log(f"slice contacts {mode} " + json.dumps(line))
    (rs, vs, ls), (rr, vr, _) = runs["stream"], runs["resident"]
    for n in ("cs", "syn"):
        if not vs[n].any() or not np.array_equal(vs[n], vr[n]):
            raise AssertionError(f"contacts: {n}_seg empty or streaming != resident")
    if (rs["n_cs"], rs["n_syn"]) != (rr["n_cs"], rr["n_syn"]) or min(rs["n_cs"], rs["n_syn"]) <= 0:
        raise AssertionError(f"contacts: counts stream {rs['n_cs']}/{rs['n_syn']} != resident "
                             f"{rr['n_cs']}/{rr['n_syn']}")
    if ls["overflow_columns"] <= 0:
        raise AssertionError("contacts: no column overflowed, the patch route did not run")
    log(f"slice contacts: streaming == resident, {rs['n_cs']} cs, {rs['n_syn']} syn, "
        f"overflow columns {ls['overflow_columns']}/{ls['columns']}")
    return ls


def phase_reference_contacts(dev, work: str):
    """Two labelled cubes with a gap: the card path against ``device="cpu"``,
    label volumes and tables equal."""
    import numpy as np

    from syconn_tpu_torch.exec.exec_syns import run_contact_extraction
    from syconn_tpu_torch.io.chunked import ChunkedVolume

    sh = (96, 64, 48)
    seg = np.zeros(sh, np.uint64)
    seg[4:46, 4:60, 4:44] = 7
    seg[48:92, 4:60, 4:44] = 9
    sj = np.zeros(sh, np.uint8)
    sj[40:54, 20:40, 10:30] = 255
    paths = {}
    for name, data in (("seg", seg), ("sj", sj), ("sym", sj * 0), ("asym", sj)):
        paths[name] = os.path.join(work, f"ref_{name}")
        cv = ChunkedVolume.create(paths[name], scale=(10, 10, 20), boundary=sh,
                                  chunk_shape=(64, 64, 64))
        cv.save_seg(data) if name == "seg" else cv.save_raw(data)
    out = {}
    for tag, d in (("card", dev), ("cpu", "cpu")):
        out_dir = os.path.join(work, f"ref_contacts_{tag}")
        res = run_contact_extraction(paths["seg"], out_dir, kd_sj_path=paths["sj"],
                                     kd_sym_path=paths["sym"], kd_asym_path=paths["asym"],
                                     chunk_size=(32, 64, 48), min_obj_vx={"cs": 1, "syn": 1},
                                     overwrite=True, device=d)
        out[tag] = (res, _load_labels(out_dir, sh))
    (rc, vc), (rh, vh) = out["card"], out["cpu"]
    for n in ("cs", "syn"):
        if not vc[n].any() or not np.array_equal(vc[n], vh[n]):
            raise AssertionError(f"reference contacts: {n}_seg empty or card != cpu")
        for key in ("ids", "sizes", "rep_coords", "bounding_boxes", "partner_ids"):
            if not np.array_equal(rc[n][key], rh[n][key]):
                raise AssertionError(f"reference contacts: {n} table {key} differs")
    for key in ("asym_prop", "sym_prop"):
        if not np.array_equal(rc["syn"][key], rh["syn"][key]):
            raise AssertionError(f"reference contacts: syn {key} differs")
    log(f"reference contacts: card == cpu, {rc['n_cs']} cs, {rc['n_syn']} syn, partners "
        f"{rc['cs']['partner_ids'].tolist()}")


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
    entries = [ln for ln in build.ptxas_log("conv3d_wgmma").splitlines()
               if "Compiling entry function" in ln]
    for mode, what in ((0, "SAME"), (1, "stride-2"), (2, "transpose")):
        if not any(f"conv3d_wgmma_kernelILi{mode}E" in ln for ln in entries):
            raise AssertionError(f"ptxas conv3d_wgmma: no {what} instantiation in the build log")
    for name in build.SOURCES:
        fn = ""
        for line in build.ptxas_log(name).splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1][-44:]
            elif "Used " in line or "spill" in line:
                log(f"ptxas {name} ..{fn}: " + line.strip())
            elif "Potential Performance Loss" in line:
                # serialised wgmmas would slow the main loop without failing anything else
                raise AssertionError(f"ptxas {name}: " + line.strip())

    rows = phase_kernels(dev)
    phase_repack(dev)
    contact_rows = phase_contact_kernels(dev)
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
        contacts = phase_slice_contacts(dev, work, sym_path=os.path.join(work, "sym"),
                                        asym_path=os.path.join(work, "asym"))
        phase_reference_contacts(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = []
    for name in REPLACES:
        rs = [r for r in rows if r["name"] == name and r["per_tile"] > 0]
        per_tile = lambda key: sum(r[key] * r["per_tile"] for r in rs)  # noqa: E731
        bf = sum(r["bound_ms"] * r["per_tile"] for r in rs if r["bound_by"] == "operations")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows if r["name"] == name),
            ms=per_tile("kernel_ms"), plain_ms=per_tile("plain_ms"),
            bound_ms=per_tile("bound_ms"),
            bound_by="operations" if bf >= 0.5 * per_tile("bound_ms") else "bytes",
            library_ms=per_tile("library_ms")))
    crow = next(r for r in contact_rows if r["main_path"])
    kernels.append(dict(
        name="detect_cs_columns", route="cuda", source=CONTACT_SOURCE, replaces=CONTACT_REPLACES,
        launches=contacts["launches"], max_abs_err=max(r["max_abs_err"] for r in contact_rows),
        ms=crow["kernel_ms"], plain_ms=crow["plain_ms"], bound_ms=crow["bound_ms"],
        bound_by=crow["bound_by"], library_ms=None))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
