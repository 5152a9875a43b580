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
     volume agrees between the card and the CPU path;
  6. step 2, SD generation (after the earlier slices, so that those measure
     the streaming path): ``predict_cellorganelles`` (the organelles U-Net,
     whose conv shapes phase 2 checks too) over the slice's raw volume,
     streamed and then resident (``ResidentDensePredictor``), outputs on disk
     equal and the registered ``mi``/``vc`` maps equal to disk; ``kd_init``
     for ``mi`` and ``vc`` on seeded blob probability maps, resident
     (``ResidentSegmenter``) and streaming through the device chain on the
     full volume, streaming and on the host (scipy) on a 256x256x128
     sub-volume, segmentations equal, and once on the registered maps;
     ``init_cell_subcell_tables``' scan of the contact slice's cell
     segmentation (one chunk of dense labels) held resident, equal to the
     host scan; the device functions of step 2 against their CPU runs, and
     each alone on one deployment chunk against its host counterpart;
  7. the slice pipeline (``phase_slice_pipeline``): steps 1, 2 and 6a through
     the working-directory configuration into ``sv``, ``mi``, ``vc``, ``cs``
     and ``syn`` SegmentationDatasets and a pruned supervoxel graph, on the
     card (all four kernels), checked against the earlier phases' functions
     and between the resident and streaming contact routes.

Phase 4's reference check also holds the organelles U-Net, layer by layer
and end to end, to its own budget (``ORG_BUDGET``).

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
# the organelles U-Net (features 32/64, one stride-2 level, patch (2, 2, 2),
# 4 classes) on the deployment tile + halo -> patched (160, 160, 80):
# (kernel, (B, X, Y, Z), cin, cout, head width, epilogue, launches per tile);
# batch 4 is the resident path's tile batch
ORG_SHAPES = [
    ("conv3x3x3_ln_gelu", (1, 160, 160, 80), 8, 32, 0, "ln_gelu", 1),
    ("conv3x3x3_ln_gelu", (1, 160, 160, 80), 32, 32, 0, "ln_gelu", 1),
    ("conv_down2x_bias", (1, 160, 160, 80), 32, 64, 0, "bias", 1),
    ("conv3x3x3_ln_gelu", (1, 80, 80, 40), 64, 64, 0, "ln_gelu", 2),
    ("conv_transpose2x_bias", (1, 80, 80, 40), 64, 32, 0, "bias", 1),
    ("conv3x3x3_ln_gelu", (1, 160, 160, 80), 64, 32, 0, "ln_gelu", 1),
    ("conv3x3x3_ln_gelu", (1, 160, 160, 80), 32, 32, 32, "ln_gelu", 1),
    ("conv3x3x3_ln_gelu", (4, 160, 160, 80), 64, 32, 0, "ln_gelu", 0),
    ("conv3x3x3_ln_gelu", (4, 160, 160, 80), 32, 32, 32, "ln_gelu", 0),
    ("conv_down2x_bias", (4, 160, 160, 80), 32, 64, 0, "bias", 0),
]
PER_TILE = {"syntype": {"conv3x3x3_ln_gelu": 10, "conv_down2x_bias": 2, "conv_transpose2x_bias": 2},
            "myelin": {"conv3x3x3_ln_gelu": 6, "conv_down2x_bias": 1, "conv_transpose2x_bias": 1},
            "organelles": {"conv3x3x3_ln_gelu": 6, "conv_down2x_bias": 1,
                           "conv_transpose2x_bias": 1}}
# step 2 (syconn_tpu/handler/default_config.yml:34, :82-128): deployment
# chunk; per organelle the blob radii (x, y, z voxels at 10 x 10 x 20 nm),
# grid spacing and pair separation (in x radii) of the seeded probability maps
STEP2_CHUNK = (256, 256, 128)
# the organelles U-Net's card-vs-CPU budget on phase_reference's input: the
# spread between the JAX package's own two implementations of this net on
# the same input (flax apply and its Pallas engine, 0.97567 within 2 LSB and
# argmax stable on 0.99838; tests/test_torch_unet.py::
# test_organelles_port_within_the_reference_spread), rounded down
ORG_BUDGET = {"within_2_lsb": 0.975, "argmax_stable": 0.998}
BLOBS = {"mi": dict(radii=(14, 14, 7), spacing=(64, 48, 32), sep=1.6, seed=21),
         "vc": dict(radii=(9, 6, 5), spacing=(48, 40, 24), sep=2.0, seed=22)}


def cell_objects() -> dict:
    """``cell_objects`` of the port's configuration (the packaged defaults
    unless a working directory is set)."""
    from syconn_tpu_torch import global_params

    return global_params.config["cell_objects"]


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
    # the organelles shapes (up to 262M input values at batch 4) draw on the card
    dgen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for task, (name, n, cin, cout, nh, epi, per_tile) in (
            [("syntype", sh) for sh in SHAPES] + [("organelles", sh) for sh in ORG_SHAPES]):
        up = name == "conv_transpose2x_bias"
        dims = (1, n, n, n) if isinstance(n, int) else tuple(n)
        vox = dims[0] * dims[1] * dims[2] * dims[3]
        if task == "syntype":
            x = torch.randn(dims + (cin,), generator=gen).to(dev, torch.bfloat16)
        else:
            x = torch.randn(dims + (cin,), generator=dgen, device=dev).to(torch.bfloat16)
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
        if (per_tile > 0 or task == "organelles" or name != "conv3x3x3_ln_gelu") and plan is None:
            raise AssertionError(f"{name} {dims} {cin}->{cout} nh={nh}: a main-path shape, and "
                                 f"every stride-2 or transposed conv, must take the wgmma kernel")
        row = dict(name=name, task=task, n=n, cin=cin, cout=cout, nh=nh, epilogue=epi,
                   per_tile=per_tile,
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
            stats = predict_synapsetype(kd_path=kd, target_paths=targets,
                                        tile_shape=(256, 256, 128), halo=(32, 32, 16),
                                        device=dev, show_progress=False)
        else:
            stats = predict_myelin(kd_path=kd, target_paths=targets,
                                   tile_shape=(256, 256, 128), halo=(32, 32, 16),
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
    small input: syntype's uint8 probabilities within 2 LSB on >= 99.9% of
    voxels; the organelles U-Net layer by layer (each layer alone within the
    conv tolerance, softmax and rounding within 1 LSB) and its probabilities
    within ORG_BUDGET."""
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
    # the organelles U-Net (trained weights, Cin 8 into the first conv): first
    # each layer on the card against the CPU plain path, alone (fed the CPU's
    # input) and chained, then the probabilities against ORG_BUDGET
    from syconn_tpu_torch.models.convert import params_from_flax
    from syconn_tpu_torch.tools.engine_layers import layer_report

    model, params = load_model(packaged_model_path("organelles"))
    rows = layer_report(model, params_from_flax(params, dev), params_from_flax(params, "cpu"),
                        vol, dev)
    for row in rows:
        log("reference organelles layer " + json.dumps(row))
    bad = [r["layer"] for r in rows[:-1] if r["alone"]["median_rel"] >= 2e-2
           or r["alone"]["share_rel_gt_0.1"] >= 2e-2]
    if bad or rows[-1]["max_lsb"] > 1:
        raise AssertionError(f"organelles: layers {bad} (alone) beyond the conv tolerance, or "
                             f"softmax/round {rows[-1]['max_lsb']} LSB apart on the same logits")
    kw = dict(tile_shape=(64, 64, 32), halo=(16, 16, 8), mode="probs")
    got = DenseTilePredictor(model, params, device=dev, **kw).predict_array(vol)
    ref = DenseTilePredictor(model, params, device="cpu", **kw).predict_array(vol)
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    org = dict(max_abs_lsb=int(d.max()), within_2_lsb=float(np.mean(d <= 2)),
               within_8_lsb=float(np.mean(d <= 8)),
               argmax_stable=float(np.mean(got.argmax(-1) == ref.argmax(-1))),
               max_prob=int(ref.max()), share_above_250=float(np.mean(ref.max(-1) > 250)),
               budget=ORG_BUDGET)
    log("reference organelles probs: " + json.dumps(org))
    if org["within_2_lsb"] < ORG_BUDGET["within_2_lsb"] or \
            org["argmax_stable"] < ORG_BUDGET["argmax_stable"]:
        raise AssertionError(f"organelles kernel path vs plain CPU path beyond its budget: {org}")
    return ok


def phase_slice_organelles(dev, work: str, kd: str, shape=(512, 512, 256)):
    """Step 1 for step 2: ``predict_cellorganelles`` streamed, then with the
    raw volume resident (``ResidentDensePredictor``). Outputs on disk equal
    (else within 3/255 with the argmax stable on >= 99.9%), every conv
    kernel launched per dispatch, the resident run's mi/vc maps registered
    and equal to disk. Returns (target paths of the resident run, launches)."""
    import numpy as np
    import torch

    from syconn_tpu_torch.exec.exec_dense_prediction import predict_cellorganelles
    from syconn_tpu_torch.io import resident
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.ops.conv3d import LAUNCHES, reset_launch_counts

    launches = {k: 0 for k in LAUNCHES}
    outs = {}
    for mode in ("stream", "resident"):
        targets = {c: os.path.join(work, f"org_{mode}_{c}") for c in ("mi", "vc", "sj")}
        if mode == "resident":
            vol = ChunkedVolume.open(kd).load_raw(size=shape)
            if not resident.put(kd, "raw", vol, device=dev):
                raise AssertionError("the resident store refused the raw volume")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        stats = predict_cellorganelles(kd_path=kd, target_paths=targets,
                                       tile_shape=(256, 256, 128), halo=(32, 32, 16),
                                       device=dev, show_progress=False)
        counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if stats["route"] != mode:
            raise AssertionError(f"organelles {mode}: took the {stats['route']} route")
        for k, per in PER_TILE["organelles"].items():
            if counts[k] <= 0 or counts[k] != stats["dispatches"] * per:
                raise AssertionError(f"organelles {mode}: {k} launched {counts[k]} times, "
                                     f"expected {stats['dispatches']} dispatches x {per}")
            launches[k] += counts[k]
        outs[mode] = {c: ChunkedVolume.open(p).load_raw(size=shape) for c, p in targets.items()}
        line = dict(stats, peak_bytes=int(peak), launches=counts,
                    tile_batch=stats.get("tile_batch", 1))
        log(f"slice organelles {mode} " + json.dumps(line))
        if mode == "resident":
            if sorted(stats["registered"]) != ["mi", "sj", "vc"]:
                raise AssertionError(f"organelles: registered {stats['registered']}, the "
                                     "resident run must register every class map")
            for c in ("mi", "vc"):
                reg = resident.get(targets[c], "raw")
                if reg is None or not np.array_equal(reg.cpu().numpy(), outs[mode][c]):
                    raise AssertionError(f"organelles: registered {c} map != disk")
            resident.drop(kd)
            res_targets = targets
    # the three stored classes and the background as 255 minus their sum
    stacked = {m: np.stack([outs[m][c] for c in ("mi", "vc", "sj")], -1).astype(np.int16)
               for m in outs}
    d = np.abs(stacked["stream"] - stacked["resident"])
    arg = [np.concatenate([255 - v.sum(-1, keepdims=True), v], -1).argmax(-1)
           for v in stacked.values()]
    stable = float(np.mean(arg[0] == arg[1]))
    log(f"slice organelles: streaming vs resident max |diff| {int(d.max())} LSB, "
        f"argmax stable {stable:.6f}, mean mi {float(outs['resident']['mi'].mean()):.3f}, "
        f"vc {float(outs['resident']['vc'].mean()):.3f}")
    if int(d.max()) > 3 or stable < 0.999:
        raise AssertionError("organelles: streaming and resident outputs differ beyond 3 LSB "
                             "or the argmax budget")
    return res_targets, launches


def blob_map(shape, co: str):
    """Seeded organelle probability map (uint8): noise below 0.8 x the
    type's threshold, and on a jittered grid anisotropic ellipsoids with a
    graded profile (255 at the centre, 127 at the rim), a quarter of them
    as touching pairs along x: one component each that the erosion-seeded
    watershed must split.
    Returns (map, number of separate blob groups, number of blobs)."""
    import numpy as np


    cfg = BLOBS[co]
    rng = np.random.default_rng(cfg["seed"])
    thr = cell_objects()["probathresholds"][co] * 255.0
    vol = rng.integers(0, int(0.8 * thr), shape, dtype=np.uint8)
    sp = np.asarray(cfg["spacing"])
    n_groups = n_blobs = 0
    for g in np.ndindex(*(np.asarray(shape) // sp)):
        kind = rng.random()
        if kind > 0.75:
            continue
        centre = (np.asarray(g) + 0.5) * sp + rng.uniform(-0.1, 0.1, 3) * sp
        radii = np.asarray(cfg["radii"]) * rng.uniform(0.9, 1.15)
        blobs = [centre]
        if kind < 0.25:
            dx = np.array([cfg["sep"] * radii[0] / 2, 0, 0])
            blobs = [centre - dx, centre + dx]
        n_groups += 1
        for c in blobs:
            n_blobs += 1
            lo = np.maximum(np.floor(c - radii).astype(int), 0)
            hi = np.minimum(np.ceil(c + radii).astype(int) + 1, shape)
            ax = [(np.arange(lo[i], hi[i]) - c[i]) / radii[i] for i in range(3)]
            d2 = ax[0][:, None, None] ** 2 + ax[1][None, :, None] ** 2 + ax[2][None, None, :] ** 2
            val = np.where(d2 <= 1, 255 * (1 - 0.5 * d2), 0).astype(np.uint8)
            box = vol[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
            np.maximum(box, val, out=box)
    return vol, n_groups, n_blobs


def phase_slice_objects(dev, work: str, registered=None, shape=(512, 512, 256)):
    """Step 2a: ``kd_init`` per organelle on seeded blob maps, resident and
    streaming through the device chain on the full volume, streaming and on
    the host on a 256x256x128 sub-volume; segmentations equal. Then on the
    maps the organelles slice registered. Returns organelle -> the resident
    run's segmentation path, and organelle -> its map's path."""
    import numpy as np
    import torch

    from syconn_tpu_torch.exec.exec_init import kd_init
    from syconn_tpu_torch.io import resident
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.ops.cc_torch import connected_components_torch
    from syconn_tpu_torch.ops.morphology import get_aniso_struct
    from syconn_tpu_torch.ops.morphology_torch import _split_ops, morphology_chain_device

    sub = STEP2_CHUNK
    seg_paths, prob_paths = {}, {}
    for co in ("mi", "vc"):
        t0 = time.perf_counter()
        prob, n_groups, n_blobs = blob_map(shape, co)
        paths = {k: os.path.join(work, f"{co}_{k}") for k in ("prob", "prob_sub")}
        for k, data in (("prob", prob), ("prob_sub", prob[:sub[0], :sub[1], :sub[2]])):
            ChunkedVolume.create(paths[k], scale=(10, 10, 20), boundary=data.shape,
                                 chunk_shape=STEP2_CHUNK).save_raw(data)
        # components of the thresholded map after the chain's opening and
        # closing, over the whole volume: the count without the watershed
        pre_ops, _ = _split_ops(cell_objects()["extract_morph_op"][co])
        thr = cell_objects()["probathresholds"][co] * 255.0
        _, n_cc = connected_components_torch(morphology_chain_device(
            prob >= thr, pre_ops, get_aniso_struct((10, 10, 20)), device=dev), device=dev)
        log(f"slice objects {co}: map {shape} with {n_blobs} blobs in {n_groups} groups, "
            f"{n_cc} components after {pre_ops}, written in {time.perf_counter() - t0:.3f} s")
        segs = {}
        runs = (("resident", "prob", shape, True), ("device", "prob", shape, True),
                ("device", "prob_sub", sub, True), ("host", "prob_sub", sub, False))
        for route, src, sh, use_device in runs:
            tag = f"{route}_{src}"
            out = os.path.join(work, f"{co}_seg_{tag}")
            if route == "resident" and not resident.put(paths[src], "raw", prob, device=dev):
                raise AssertionError("the resident store refused the probability map")
            torch.cuda.synchronize()
            stats = kd_init(co, chunk_size=STEP2_CHUNK, proba_path=paths[src], target_path=out,
                            overwrite=True, use_device=use_device, device=dev)
            resident.drop(paths[src])
            if stats["route"] != route:
                raise AssertionError(f"objects {co} {tag}: took the {stats['route']} route")
            segs[tag] = ChunkedVolume.open(out).load_seg(size=sh)
            line = dict(stats, volume=list(sh), mvox_per_s=float(np.prod(sh)) / stats["seconds"] / 1e6)
            log(f"slice objects {co} {route} " + json.dumps(line))
            if route == "resident":
                seg_paths[co] = out
                n_obj = stats["n_objects"]
        for a, b in (("resident_prob", "device_prob"), ("device_prob_sub", "host_prob_sub")):
            if not segs[a].any() or not np.array_equal(segs[a], segs[b]):
                raise AssertionError(f"objects {co}: {a} segmentation empty or != {b}")
        if n_obj <= n_cc:
            raise AssertionError(f"objects {co}: {n_obj} objects from {n_cc} components; "
                                 "the watershed split none")
        log(f"slice objects {co}: resident == device (full), device == host (sub-volume); "
            f"{n_obj} objects from {n_cc} components, {n_blobs} blobs in {n_groups} groups")
        prob_paths[co] = paths["prob"]
    if registered:
        for co in ("mi", "vc"):
            if resident.get(registered[co], "raw") is None:
                raise AssertionError(f"the registered {co} map is gone")
            stats = kd_init(co, chunk_size=STEP2_CHUNK, proba_path=registered[co],
                            target_path=os.path.join(work, f"{co}_seg_chain"), overwrite=True,
                            device=dev)
            if stats["route"] != "resident":
                raise AssertionError(f"objects {co} chain: took the {stats['route']} route")
            log(f"slice objects {co} chain " + json.dumps(stats))
    return seg_paths, prob_paths


def phase_slice_props(dev, work: str, seg_paths, prob_paths, shape=(512, 512, 256),
                      min_objects: int = 100):
    """Step 2b: ``init_cell_subcell_tables`` over the contact slice's cell
    segmentation (one chunk of dense labels, > 4096 ids) held resident, and
    the mi/vc segmentations; tables and mapping counts equal to the host
    scan's, at least ``min_objects`` per organelle after ``min_obj_vx``."""
    import numpy as np
    import torch

    from syconn_tpu_torch.exec.exec_init import init_cell_subcell_tables
    from syconn_tpu_torch.io import resident
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.proc.sd_proc import map_subcell_extract_props_tables

    hot = (tuple(s // 5 for s in shape), tuple(max(8, s // 12) for s in shape))
    seg = blocky_labels(shape, (48, 48, 96), seed=7, hot=hot)
    c = STEP2_CHUNK
    dense = np.arange(np.prod([x // 8 for x in c]), dtype=np.uint64).reshape(
        [x // 8 for x in c]) + (1 << 24)
    for ax in range(3):
        dense = np.repeat(dense, 8, axis=ax)
    seg[c[0]:2 * c[0], :c[1], :c[2]] = dense  # chunk (1, 0, 0): 16384 ids at the deployment chunk
    seg_path = os.path.join(work, "sv_seg_props")
    ChunkedVolume.create(seg_path, scale=(10, 10, 20), boundary=shape,
                         chunk_shape=STEP2_CHUNK).save_seg(seg)
    if not resident.put(seg_path, "seg", seg, device=dev):
        raise AssertionError("the resident store refused the cell segmentation")
    torch.cuda.synchronize()
    # overwrite=False: the segmentations of the objects slice are complete
    # and kept; the scan's cache starts empty
    res = init_cell_subcell_tables(seg_path, prob_paths, seg_paths, chunk_size=STEP2_CHUNK,
                                   overwrite=False, device=dev)
    resident.clear()
    ref = map_subcell_extract_props_tables(
        seg_path, {co: seg_paths[co] for co in ("mi", "vc")}, chunk_shape=STEP2_CHUNK,
        min_obj_vx=cell_objects()["min_obj_vx"], cache_root=os.path.join(work, "props_host"),
        device=dev)
    if any(v is not None for v in res["extraction"].values()):
        raise AssertionError("props: the complete organelle segmentations were extracted again")
    if res["stats"]["cell_route"] != "resident" or ref["stats"]["cell_route"] != "host":
        raise AssertionError(f"props: routes {res['stats']['cell_route']}/"
                             f"{ref['stats']['cell_route']}")
    for t in ("sv", "mi", "vc"):
        for a, b in zip(res["tables"][t], ref["tables"][t]):
            if not np.array_equal(a, b):
                raise AssertionError(f"props: {t} table of the resident scan != host scan")
    if res["mapping"] != ref["mapping"] or res["sc_sizes"] != ref["sc_sizes"]:
        raise AssertionError("props: mapping counts differ between the scans")
    if min(res["counts"]["mi"], res["counts"]["vc"]) < min_objects or \
            res["counts"]["sv"] <= dense.max() - (1 << 24) + 1:
        raise AssertionError(f"props: counts {res['counts']}")
    for tag, r in (("resident", res), ("host", ref)):
        st = r["stats"]
        line = dict(st, counts=r["counts"], mvox_per_s=float(np.prod(shape)) / st["seconds"] / 1e6,
                    cell_scan_ms_per_chunk=st["cell_scan_seconds"] / st["chunks"] * 1e3)
        log(f"slice props {tag} " + json.dumps(line))
    log(f"slice props: resident scan == host scan, counts {res['counts']}")


def phase_step2_ops(dev):
    """Step 2's device functions, each alone on one deployment chunk (the mi
    window: chunk + halo 17 = 290 x 290 x 162; label chunks 256 x 256 x
    128), against the host function the JAX package's host route runs on
    the same input. Device ops without a host sync inside are timed with
    CUDA events (``cuda_ms``); those that sync (connected components: one
    sync a round; the wrappers' readbacks) by the host clock around a
    synchronised call, median of 3."""
    import numpy as np
    import torch
    from scipy import ndimage

    from syconn_tpu_torch.ops.cc_torch import (connected_components_device,
                                               connected_components_torch)
    from syconn_tpu_torch.ops.morphology import apply_morphological_operations, get_aniso_struct
    from syconn_tpu_torch.ops.morphology_torch import (_segment_chunk_packed, _split_ops,
                                                       segment_chunk_device)
    from syconn_tpu_torch.ops.props import object_properties_arrays, pair_counts
    from syconn_tpu_torch.ops.props_torch import (ResidentPropsScanner, object_properties_device,
                                                  pair_counts_device)

    def wall_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2]

    def host_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out

    struct = get_aniso_struct((10, 10, 20))
    ops = cell_objects()["extract_morph_op"]["mi"]
    thr = cell_objects()["probathresholds"]["mi"] * 255.0
    pre, n_tr = _split_ops(ops)
    win = (STEP2_CHUNK[0] + 34, STEP2_CHUNK[1] + 34, STEP2_CHUNK[2] + 34)
    prob, _, _ = blob_map(win, "mi")
    prob_d = torch.from_numpy(prob).to(dev)
    struct_d = torch.from_numpy(struct).to(dev)
    rows = []

    def row(op, shape, ms, timing, host, host_what):
        r = dict(op=op, input=list(shape), ms=ms, timing=timing, host_ms=host, host=host_what)
        rows.append(r)
        log("step2 op " + json.dumps(r))

    ms = cuda_ms(lambda: _segment_chunk_packed(prob_d, thr, struct_d, pre, n_tr, 0.0),
                 warmup=2, reps=5, inner=4)
    h, (mask, eroded) = host_ms(lambda: (lambda m: (m, apply_morphological_operations(
        m, ["binary_erosion"] * n_tr, struct=struct)))(apply_morphological_operations(
            prob >= thr, list(pre), struct=struct)))
    row("_segment_chunk_packed (mi chain: 8 SE-count convs, pack)", win, ms, "cuda events", h,
        "scipy apply_morphological_operations")
    ms = wall_ms(lambda: segment_chunk_device(prob, thr, ops, struct, device=dev))
    row("segment_chunk_device (upload, chain, packed readback, unpack)", win, ms, "wall", h,
        "scipy apply_morphological_operations")
    got = segment_chunk_device(prob, thr, ops, struct, device=dev)
    if not (np.array_equal(got[0], mask) and np.array_equal(got[1], eroded)):
        raise AssertionError("step2 ops: device chain != scipy chain on the mi window")
    er_d = torch.from_numpy(eroded).to(dev)
    ms = wall_ms(lambda: connected_components_device(er_d))
    h, (lab_h, n_h) = host_ms(lambda: ndimage.label(
        eroded, structure=ndimage.generate_binary_structure(3, 1)))
    row("connected_components_device (eroded mi seeds)", win, ms, "wall", h, "scipy ndimage.label")
    ms = wall_ms(lambda: connected_components_torch(eroded, device=dev))
    lab_t, n_t = connected_components_torch(eroded, device=dev)
    if n_t != n_h or not np.array_equal(lab_t, lab_h):
        raise AssertionError("step2 ops: device CC != scipy on the mi seeds")
    row("connected_components_torch (upload, CC, compact, download)", win, ms, "wall", h,
        "scipy ndimage.label")
    cell = blocky_labels(STEP2_CHUNK, (48, 48, 96), seed=7).astype(np.int32)
    c8 = [x // 8 for x in STEP2_CHUNK]
    dense = np.arange(np.prod(c8), dtype=np.int32).reshape(c8) + 1
    for ax in range(3):
        dense = np.repeat(dense, 8, axis=ax)
    mi_lab = lab_t[17:17 + STEP2_CHUNK[0], 17:17 + STEP2_CHUNK[1], 17:17 + STEP2_CHUNK[2]]
    for name, vol, mx in (("blocky cell labels", cell, 4096),
                          (f"dense labels, {int(dense.max())} ids", dense, int(dense.max()))):
        vd = torch.from_numpy(vol).to(dev)
        ms = cuda_ms(lambda: object_properties_device(vd, mx), warmup=2, reps=5, inner=4)
        h, _ = host_ms(lambda: object_properties_arrays(vol))
        row(f"object_properties_device ({name}, max_ids {mx})", vol.shape, ms, "cuda events", h,
            "object_properties_arrays")
        scan = ResidentPropsScanner(vd, chunk=STEP2_CHUNK)
        ms = wall_ms(lambda: scan.props((0, 0, 0)))
        row(f"ResidentPropsScanner.props ({name}, from max_ids 4096)", vol.shape, ms, "wall", h,
            "object_properties_arrays")
    a_d = torch.from_numpy(mi_lab.astype(np.int32)).to(dev)
    c_d = torch.from_numpy(cell).to(dev)
    ms = cuda_ms(lambda: pair_counts_device(a_d, c_d, 4096), warmup=2, reps=5, inner=4)
    h, _ = host_ms(lambda: pair_counts(mi_lab, cell))
    row("pair_counts_device (mi labels x cell labels)", mi_lab.shape, ms, "cuda events", h,
        "pair_counts")
    return rows


def phase_reference_step2(dev):
    """The device functions of step 2 on the card against their CPU runs on
    small seeded inputs: all exact."""
    import numpy as np
    import torch

    from syconn_tpu_torch.ops.cc_torch import connected_components_device
    from syconn_tpu_torch.ops.morphology import get_aniso_struct
    from syconn_tpu_torch.ops.morphology_torch import morphology_chain_device
    from syconn_tpu_torch.ops.props_torch import object_properties_device, pair_counts_device

    rng = np.random.default_rng(9)
    struct = get_aniso_struct((10, 10, 20))
    mask = rng.random((64, 56, 40)) < 0.45
    ops = ["binary_opening", "binary_closing"] + ["binary_erosion"] * 4
    checks = {"morphology_chain_device": np.array_equal(
        morphology_chain_device(mask, ops, struct, device=dev),
        morphology_chain_device(mask, ops, struct, device="cpu"))}
    m = torch.from_numpy(rng.random((64, 56, 40)) < 0.5)
    checks["connected_components_device"] = torch.equal(
        connected_components_device(m.to(dev)).cpu(), connected_components_device(m))
    vol = torch.from_numpy(rng.integers(0, 3000, (64, 48, 40)).astype(np.int32))
    checks["object_properties_device"] = all(
        torch.equal(a.cpu(), b) for mx in (1024, 4096) for a, b in zip(
            object_properties_device(vol.to(dev), mx), object_properties_device(vol, mx)))
    a = torch.from_numpy(rng.integers(0, 40, (64, 48, 40)).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 40, (64, 48, 40)).astype(np.int32))
    checks["pair_counts_device"] = all(
        torch.equal(x.cpu(), y) for mx in (256, 2048) for x, y in zip(
            pair_counts_device(a.to(dev), b.to(dev), mx), pair_counts_device(a, b, mx)))
    log("reference step2: card == cpu " + json.dumps(checks))
    if not all(checks.values()):
        raise AssertionError(f"step 2 device functions differ from the CPU: {checks}")


def _same(a, b) -> bool:
    """Exact equality of nested attribute values (arrays by dtype, shape and
    content)."""
    import numpy as np

    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        if not (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape):
            return False
        if a.dtype == object:
            return all(_same(x, y) for x, y in zip(a.ravel(), b.ravel()))
        return bool(np.array_equal(a, b))
    return type(a) is type(b) and a == b


def _dataset_state(sd):
    """A dataset's numpy caches and per-shard attribute dicts."""
    import glob

    import numpy as np

    from syconn_tpu_torch.backend import AttributeDict

    caches = {os.path.basename(p): np.load(p, allow_pickle=True)
              for p in sorted(glob.glob(os.path.join(sd.path, "*.npy")))}
    attrs = {}
    for d in sd.so_dir_paths:
        p = os.path.join(d, "attr_dict.pkl")
        if os.path.isfile(p):
            attrs.update(AttributeDict(p, read_only=True, disable_locking=True).copy_intern())
    return caches, attrs


def phase_slice_pipeline(dev, work: str, shape=(512, 512, 256)):
    """Steps 1, 2 and 6a through the working-directory configuration, on the
    card, into SegmentationDatasets: the dense slice's raw volume and the
    contact slice's cell segmentation in ``<wd>/knossosdatasets/seg``;
    ``predict_cellorganelles(mag=1)`` (the organelles U-Net on the three conv
    kernels); the seeded mi/vc maps of ``slice objects`` and the sj map of
    ``slice contacts`` written over the predicted ones (the toy-trained
    weights find no organelles on smoothed noise); ``init_cell_subcell_sds``
    with meshes, the cell segmentation resident; ``run_create_rag`` on a
    seeded graph over the cell ids; ``run_syn_generation`` up to
    ``extract_contact_sites`` with the segmentation resident, and again in a
    second working directory over the same volumes, streaming through the
    contact kernel. Checks: the five datasets reopen, their ids/sizes caches
    equal the tables of ``map_subcell_extract_props_tables`` /
    ``run_contact_extraction`` on the same inputs, sampled objects' meshes,
    voxels and mapping attributes, resident == streaming for cs/syn.
    Returns the kernels' launches in this phase."""
    import shutil

    import numpy as np
    import torch

    from syconn_tpu_torch import global_params
    from syconn_tpu_torch.backend import VoxelStorageLazyLoading
    from syconn_tpu_torch.exec import exec_dense_prediction, exec_init, exec_syns
    from syconn_tpu_torch.handler.config import generate_default_conf
    from syconn_tpu_torch.io import resident
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.io.graph import save_svgraph
    from syconn_tpu_torch.ops.conv3d import LAUNCHES, reset_launch_counts
    from syconn_tpu_torch.proc.sd_proc import map_subcell_extract_props_tables
    from syconn_tpu_torch.reps.segmentation import SegmentationDataset

    mvox = float(np.prod(shape)) / 1e6
    wd = os.path.join(work, "pipeline_wd")
    generate_default_conf(wd, scaling=(10, 10, 20))
    global_params.wd = wd
    cfg = global_params.config

    def put(path, data, channel):
        shutil.rmtree(path, ignore_errors=True)
        cv = ChunkedVolume.create(path, scale=(10, 10, 20), boundary=shape,
                                  chunk_shape=STEP2_CHUNK)
        cv.save_raw(data) if channel == "raw" else cv.save_seg(data)
        return cv

    t0 = time.perf_counter()
    seg = ChunkedVolume.open(os.path.join(work, "sv_seg")).load_seg(size=shape)
    kd = put(cfg.kd_seg_path, ChunkedVolume.open(os.path.join(work, "raw")).load_raw(size=shape),
             "raw")
    kd.save_seg(seg)
    log(f"slice pipeline: working directory {shape} raw + seg written in "
        f"{time.perf_counter() - t0:.3f} s")
    stages = {}

    # step 1 through the config: the organelles U-Net on the three conv kernels
    torch.cuda.synchronize()
    reset_launch_counts()
    st = exec_dense_prediction.predict_cellorganelles(mag=1, device=dev, show_progress=False)
    launches = dict(LAUNCHES)
    for k, per in PER_TILE["organelles"].items():
        if launches[k] <= 0 or launches[k] != st["dispatches"] * per:
            raise AssertionError(f"pipeline prediction: {k} launched {launches[k]} times, "
                                 f"expected {st['dispatches']} dispatches x {per}")
    stages["prediction"] = dict(seconds=st["seconds"], mvox_per_s=st["mvox_per_s"],
                                dispatches=st["dispatches"], route=st["route"])
    for co, src in (("mi", "mi_prob"), ("vc", "vc_prob"), ("sj", "sj")):
        put(getattr(cfg, f"kd_{co}_path"),
            ChunkedVolume.open(os.path.join(work, src)).load_raw(size=shape), "raw")
    log("slice pipeline: predicted mi/vc/sj maps overwritten by the seeded maps of slice "
        "objects (mi, vc) and slice contacts (sj): the toy-trained organelles weights find "
        "no organelles on smoothed noise")

    # step 2 through the config, the cell segmentation resident for the scan
    if not resident.put(cfg.kd_seg_path, "seg", seg, device=dev):
        raise AssertionError("the resident store refused the cell segmentation")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res2 = exec_init.init_cell_subcell_sds(chunk_size=STEP2_CHUNK, device=dev)
    t_step2 = time.perf_counter() - t0
    sc = res2["stats"]["scan"]
    if sc["cell_route"] != "resident":
        raise AssertionError(f"pipeline scan: took the {sc['cell_route']} route")
    for co, ex in res2["stats"]["extraction"].items():
        stages[f"extraction_{co}"] = dict(seconds=ex["seconds"], route=ex["route"],
                                          n_objects=ex["n_objects"],
                                          mvox_per_s=mvox / ex["seconds"])
    scan_s = sc["seconds"]
    stages["scan"] = dict(seconds=scan_s, mvox_per_s=mvox / scan_s, chunks=sc["chunks"],
                          mesh_thread_seconds=sc["mesh_seconds"],
                          cell_scan_thread_seconds=sc["cell_scan_seconds"],
                          organelle_scan_thread_seconds=sc["organelle_scan_seconds"],
                          pair_thread_seconds=sc["pair_seconds"])
    stages["write"] = dict(seconds=sc["write_seconds"], mvox_per_s=mvox / sc["write_seconds"])
    da_s = res2["stats"]["dataset_analysis_seconds"]
    stages["dataset_analysis"] = dict(seconds=da_s, mvox_per_s=mvox / da_s)
    stages["step2_total"] = dict(seconds=t_step2, mvox_per_s=mvox / t_step2)

    # the RAG: a seeded graph over the cell ids, pruned by component size
    ids = np.unique(seg)
    ids = ids[ids != 0]
    rng = np.random.default_rng(11)
    save_svgraph({"edges": rng.choice(ids, size=(len(ids) // 2, 2)), "nodes": ids},
                 cfg.init_svgraph_path)
    t0 = time.perf_counter()
    pruned = exec_init.run_create_rag()
    rag_s = time.perf_counter() - t0
    stages["rag"] = dict(seconds=rag_s, mvox_per_s=mvox / rag_s, nodes_before=int(len(ids)),
                         nodes_after=int(len(pruned["nodes"])), edges=int(len(pruned["edges"])))
    log(f"slice pipeline RAG: {len(ids)} supervoxels -> {len(pruned['nodes'])} nodes after "
        f"pruning (min_cc_size_ssv {cfg['min_cc_size_ssv']} nm)")

    # step 6a: the segmentation resident, then streaming in a second working
    # directory over the same volumes (through the contact kernel)
    torch.cuda.synchronize()
    res6 = exec_syns.run_syn_generation(chunk_size=STEP2_CHUNK, until="extract_contact_sites",
                                        device=dev)
    resident.clear()
    wd2 = os.path.join(work, "pipeline_wd_stream")
    generate_default_conf(wd2, scaling=(10, 10, 20), key_value_pairs=[
        ("paths", {"kd_seg": cfg.kd_seg_path, "kd_sj": cfg.kd_sj_path})])
    global_params.wd = wd2
    torch.cuda.synchronize()
    reset_launch_counts()
    res6s = exec_syns.run_syn_generation(chunk_size=STEP2_CHUNK, until="extract_contact_sites",
                                         device=dev)
    launches["detect_cs_columns"] = LAUNCHES["detect_cs_columns"]
    global_params.wd = wd
    if res6["stats"]["path"] != "resident" or res6s["stats"]["path"] != "stream" or not (
            launches["detect_cs_columns"] == res6s["stats"]["dispatched"] > 0):
        raise AssertionError(f"pipeline contacts: paths {res6['stats']['path']}/"
                             f"{res6s['stats']['path']}, kernel launched "
                             f"{launches['detect_cs_columns']} times for "
                             f"{res6s['stats']['dispatched']} chunks")
    for tag, r in (("resident", res6), ("stream", res6s)):
        stages[f"contacts_{tag}"] = dict(seconds=r["stats"]["seconds"],
                                         mvox_per_s=mvox / r["stats"]["seconds"],
                                         write_seconds=r["stats"]["write_seconds"],
                                         n_cs=r["n_cs"], n_syn=r["n_syn"])
    for t in ("cs", "syn"):
        a = _dataset_state(SegmentationDataset(t, working_dir=wd))
        b = _dataset_state(SegmentationDataset(t, working_dir=wd2))
        la = ChunkedVolume.open(os.path.join(wd, "knossosdatasets", f"{t}_seg")).load_seg(size=shape)
        lb = ChunkedVolume.open(os.path.join(wd2, "knossosdatasets", f"{t}_seg")).load_seg(size=shape)
        if not (_same(a, b) and np.array_equal(la, lb)):
            raise AssertionError(f"pipeline contacts: {t} dataset resident != streaming")

    # the tables of the existing functions on the same inputs
    co_cfg = cfg["cell_objects"]
    tables = map_subcell_extract_props_tables(
        cfg.kd_seg_path, cfg.kd_organelle_seg_paths, chunk_shape=STEP2_CHUNK,
        min_obj_vx=co_cfg["min_obj_vx"], cache_root=os.path.join(work, "pipeline_tables"),
        device=dev)["tables"]
    cs_tables = exec_syns.run_contact_extraction(
        cfg.kd_seg_path, os.path.join(work, "pipeline_cs_tables"), kd_sj_path=cfg.kd_sj_path,
        chunk_size=STEP2_CHUNK, stencil=co_cfg["cs_filtersize"], cs_dilation=co_cfg["cs_dilation"],
        sj_thresh=co_cfg["probathresholds"]["sj"],
        min_obj_vx={t: co_cfg["min_obj_vx"][t] for t in ("cs", "syn")}, overwrite=True,
        device=dev)
    scale = np.array(cfg["scaling"], np.float64)
    checked = {}
    for t in ("sv", "mi", "vc", "cs", "syn"):
        sd = SegmentationDataset(t)
        want = (tables[t][0], tables[t][3]) if t in tables else \
            (cs_tables[t]["ids"], cs_tables[t]["sizes"])
        if not (sd.exists() and np.array_equal(sd.ids, want[0]) and
                np.array_equal(sd.sizes, want[1]) and len(sd.ids) > 0):
            raise AssertionError(f"pipeline: {t} dataset ids/sizes != the tables ({len(sd.ids)} "
                                 f"vs {len(want[0])} objects)")
        big = sd.ids[sd.sizes >= 1000] if t in ("sv", "mi", "vc") else sd.ids
        sample = rng.choice(big, size=min(5, len(big)), replace=False)
        for oid in sample.tolist():
            so = sd.get_segmentation_object(oid)
            size = so.size
            bb = so.bounding_box
            if t in ("sv", "mi", "vc"):
                mesh = so.mesh
                ds = np.array(cfg["meshes"]["downsampling"][t], np.float64)
                v = mesh[1].reshape(-1, 3)
                lo, hi = (bb[0] - 2 * ds) * scale, (bb[1] + 2 * ds) * scale
                mask, off = so.voxel_mask_offset()
                keys = ["mapping_mi_ids", "mapping_vc_ids"] if t == "sv" else ["mapping_ids"]
                ok = (len(v) > 0 and bool(np.isfinite(v).all()) and bool((v >= lo).all())
                      and bool((v <= hi).all()) and int(mask.sum()) == size
                      and all(so.lookup_in_attribute_dict(k) is not None for k in keys))
            else:
                lab = ChunkedVolume.open(os.path.join(wd, "knossosdatasets", f"{t}_seg")).load_seg(
                    offset=bb[0], size=bb[1] - bb[0])
                ok = int((lab == oid).sum()) == size and \
                    so.lookup_in_attribute_dict("partner_ids") is not None
                if t == "syn":
                    vox = VoxelStorageLazyLoading(
                        os.path.join(so.segobj_dir, "voxel_lazy.npz"))[oid] - bb[0]
                    ok = ok and len(vox) == size and bool(
                        (lab[vox[:, 0], vox[:, 1], vox[:, 2]] == oid).all())
            if not ok:
                raise AssertionError(f"pipeline: {t} object {oid} mesh/voxels/attributes wrong")
        checked[t] = dict(objects=int(len(sd.ids)), sampled=int(len(sample)))
    log("slice pipeline datasets: " + json.dumps(checked))
    for name, st_ in stages.items():
        log(f"slice pipeline {name} " + json.dumps(st_))
    global_params.wd = None
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "syconn_tpu_torch")):
        print("chip_smoke: run from a checkout holding syconn_tpu_torch", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from syconn_tpu_torch.io import resident
    from syconn_tpu_torch.ops import build
    from syconn_tpu_torch.utils.device import default_device

    t_all = time.perf_counter()
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
        t_step2 = time.perf_counter()
        fwd["organelles"] = phase_forward(dev, "organelles")
        registered, org_launches = phase_slice_organelles(dev, work, os.path.join(work, "raw"))
        for k, n in org_launches.items():
            launches[k] += n
        seg_paths, prob_paths = phase_slice_objects(dev, work, registered)
        resident.clear()
        phase_slice_props(dev, work, seg_paths, prob_paths)
        phase_reference_step2(dev)
        phase_step2_ops(dev)
        log(f"step 2 phases {time.perf_counter() - t_step2:.3f} s")
        t_pipe = time.perf_counter()
        pipe_launches = phase_slice_pipeline(dev, work)
        for k in REPLACES:
            launches[k] += pipe_launches[k]
        contacts["launches"] += pipe_launches["detect_cs_columns"]
        log(f"slice pipeline phase {time.perf_counter() - t_pipe:.3f} s")
    finally:
        resident.clear()
        shutil.rmtree(work, ignore_errors=True)

    for name in REPLACES:
        rs = [r for r in rows if r["name"] == name and r["task"] == "organelles" and r["per_tile"] > 0]
        log(f"organelles tile {name}: " + json.dumps(dict(
            ms=sum(r["kernel_ms"] * r["per_tile"] for r in rs),
            plain_ms=sum(r["plain_ms"] * r["per_tile"] for r in rs),
            library_ms=sum(r["library_ms"] * r["per_tile"] for r in rs),
            bound_ms=sum(r["bound_ms"] * r["per_tile"] for r in rs),
            launches_per_tile=sum(r["per_tile"] for r in rs))))

    kernels = []
    for name in REPLACES:
        rs = [r for r in rows if r["name"] == name and r["task"] == "syntype" and r["per_tile"] > 0]
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
    log(f"whole run {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
