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
  6b. training (``phase_slice_training``, before the pipeline so that its
     launches count): the organelles U-Net at its published width and myelin
     at mag 4 trained through ``cnn/toy.py`` on a seeded toy world (ms a
     step, voxels/s, peak bytes, losses finite and falling), myelin
     calibrated on the card (threshold, seconds, launches; probabilities
     against the plain version and against the initial weights'), one step
     card against CPU for the U-Net, the celltype point net and the view
     CMN, and the trained organelles nets (published width and ``start.py``'s
     override) deployed through ``predict_cellorganelles`` and
     ``generate_subcell_kd_from_proba``, every conv layer held to its plain
     version at the shapes of the calibration and deployment tiles;
  7. the slice pipeline (``phase_slice_pipeline``): steps 1, 2 and 6a through
     the working-directory configuration into ``sv``, ``mi``, ``vc``, ``cs``
     and ``syn`` SegmentationDatasets and a pruned supervoxel graph, on the
     card (all four kernels), checked against the earlier phases' functions
     and between the resident and streaming contact routes;
  8. the point nets (``phase_points``): the five packaged nets, each on 16
     contexts at its own npoints, card against CPU (kNN indices equal,
     logits within the dense budget), with forward, kNN and memory numbers;
  9. the cells (``phase_slice_cells``): on the pipeline's working directory
     ``predict_myelin``, step 3 (astrocyte prediction on the card and the
     split, in a copy with ``prior_astrocyte_removal``; glia probabilities
     card against CPU on sampled SVs), step 4 (the SuperSegmentationDataset)
     and step 5 (TEASAR skeletons through the C++ host kernel, myelin per
     node), each checked;
 10. the synapses (``phase_slice_synapses``): steps 6 and 6.5 on the same
     working directory with ``syntype_avail: True``: ``predict_synapsetype``
     (the syntype U-Net on the three conv kernels), ``run_syn_generation``
     whole (the contact kernel, then ``syn_ssv``, organelle mapping,
     ``syn_prob``, the cells' synapse lists) and ``run_cs_ssv_generation``,
     each dataset checked (ids, partners, signs, caches, meshes);
 11. the morphology (``phase_slice_morphology``): steps 7-9 and the export
     (axoness, spiness, spine-head volumes, the embedding, cell types, the
     matrix), the outputs checked per cell and the four point-net
     predictions card against CPU on 10 cells;
 12. the views (``phase_views``, after the point nets): the splat renderer
     on a seeded blob mesh at 64 locations, at the inference functions' 128x64 and the
     config's 256x128 (device and wall ms per chunk of 16 locations,
     frames/s, peak memory), card against CPU (depth and index views
     equal), and the five view nets at the inference functions' widths (forward ms a
     batch of 8, logits card against CPU within the dense budget);
 13. the view route (``phase_slice_views``): steps 7-9 with
     ``use_point_models: False`` on a copy of the pipeline's cells
     (rendering, the axoness semseg with the per-location average, the
     embedding, cell types, the astrocyte components' views and glia
     probabilities), per-stage seconds and busy shares, the outputs checked
     per cell and card against CPU on 5 cells;
 14. the pipeline driver (``phase_slice_driver``, last): the device world
     generator card against CPU, then ``examples/start.py``'s ``main`` on the
     card twice: run A on a 512x512x256 Voronoi world of 16 cells from the
     device generator with ``--predict_organelles`` (every step, seconds per
     step and per gigavoxel), run B on the quality fixture (a 160x160x80
     neuron world of 8 cells) and its scores; in each the organelles and
     myelin U-Nets' conv launches equal dispatches x launches a tile, the
     contact kernel's launches equal the chunks, and every cell, synapse
     and matrix row is checked.

Phase 4's reference check also holds the organelles U-Net, layer by layer
and end to end, to its own budget (``ORG_BUDGET``), on two seeded inputs.

The line before last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Exits non-zero without a result
when CUDA is unavailable or the package is missing.
"""

from __future__ import annotations

import glob
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
    # the driver's step 6: the default 128x128x64 chunk plus halo; blocks of
    # half the driver world's mean supervoxel (67.1 MVx / (16 cells x 3))
    ("driver", (140, 140, 70), (13, 13, 7), (32, 32), 32, (112, 112, 56), True),
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
    from syconn_tpu_torch.ops.contacts_torch import column_tables

    int_max = np.iinfo(np.int32).max
    rows = []
    for label, shape, stencil, tile_xy, K, block, main in shapes or CONTACT_SHAPES:
        seg = blocky_labels(shape, block, seed=11)
        seg_p, offs, cands, overflow = column_tables(
            torch.from_numpy(seg.astype(np.int32)).to(dev), stencil, tile_xy, K)
        args = [seg_p, offs, cands]
        cands, overflow = cands.cpu().numpy(), overflow.cpu().numpy()
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
        nbytes = seg_p.numel() * 4 + 2 * 4 * n_out
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
        if st["path"] != mode or st["dispatched"] != n_chunks or st["host_chunks"] != 0:
            raise AssertionError(f"contacts {mode}: took path {st['path']}, dispatched "
                                 f"{st['dispatched']} of {n_chunks} chunks, host {st['host_chunks']}")
        if dev.type == "cuda" and not (counts["detect_cs_columns"] == st["dispatched"] > 0):
            raise AssertionError(f"contacts {mode}: kernel launched {counts['detect_cs_columns']} "
                                 f"times for {st['dispatched']} dispatched chunks")
        line = dict(st, n_cs=res["n_cs"], n_syn=res["n_syn"], peak_bytes=int(peak),
                    launches=counts["detect_cs_columns"],
                    mvox_per_s=float(np.prod(shape)) / st["seconds"] / 1e6,
                    overflow_share=st["overflow_columns"] / max(1, st["columns"]))
        runs[mode] = (res, _load_labels(out_dir, shape), line)
        log(f"slice contacts {mode} " + json.dumps(line))
    (rs, vs, ls), (rr, vr, lr) = runs["stream"], runs["resident"]
    for n in ("cs", "syn"):
        if not vs[n].any() or not np.array_equal(vs[n], vr[n]):
            raise AssertionError(f"contacts: {n}_seg empty or streaming != resident")
    if (rs["n_cs"], rs["n_syn"]) != (rr["n_cs"], rr["n_syn"]) or min(rs["n_cs"], rs["n_syn"]) <= 0:
        raise AssertionError(f"contacts: counts stream {rs['n_cs']}/{rs['n_syn']} != resident "
                             f"{rr['n_cs']}/{rr['n_syn']}")
    if not lr["overflow_columns"] == ls["overflow_columns"] > 0:
        raise AssertionError(f"contacts: overflow columns stream {ls['overflow_columns']}, "
                             f"resident {lr['overflow_columns']}: the patch route did not run "
                             f"on both, or not on the same columns")
    log(f"slice contacts: streaming == resident, {rs['n_cs']} cs, {rs['n_syn']} syn, "
        f"overflow columns {ls['overflow_columns']}/{ls['columns']}")
    return dict(ls, launches=ls["launches"] + lr["launches"])


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
    within ORG_BUDGET on that input and on a second seeded one."""
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
    # the probabilities against ORG_BUDGET on the input of the budget's
    # derivation and on a second seeded input of the same kind
    kw = dict(tile_shape=(64, 64, 32), halo=(16, 16, 8), mode="probs")
    inputs = {"seed 1": vol, "seed 2": np.random.default_rng(2).integers(
        0, 256, (64, 64, 32), dtype=np.uint8)}
    for name, x in inputs.items():
        got = DenseTilePredictor(model, params, device=dev, **kw).predict_array(x)
        ref = DenseTilePredictor(model, params, device="cpu", **kw).predict_array(x)
        d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        org = dict(input=name, max_abs_lsb=int(d.max()), within_2_lsb=float(np.mean(d <= 2)),
                   within_8_lsb=float(np.mean(d <= 8)),
                   argmax_stable=float(np.mean(got.argmax(-1) == ref.argmax(-1))),
                   max_prob=int(ref.max()), share_above_250=float(np.mean(ref.max(-1) > 250)),
                   budget=ORG_BUDGET)
        log("reference organelles probs: " + json.dumps(org))
        if org["within_2_lsb"] < ORG_BUDGET["within_2_lsb"] or \
                org["argmax_stable"] < ORG_BUDGET["argmax_stable"]:
            raise AssertionError(f"organelles kernel path vs plain CPU path beyond its budget "
                                 f"on input {name}: {org}")
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

# point nets (syconn_tpu/models/pretrained/*_pts, spiness): task -> model
POINT_NETS = ["celltype_pts", "compartment_pts", "glia_pts", "spiness", "tnet_pts"]
# glia probability (an SV's mean class-1 softmax), card against the CPU:
# the budget tests/test_torch_cells.py holds the port to against the JAX
# package
GLIA_ATOL = 1e-2


def _blob_mask(shape=(160, 160, 80), seed: int = 31):
    """A seeded blob: an ellipsoid with smoothed random bumps."""
    import numpy as np
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    x, y, z = np.meshgrid(*[np.linspace(-1, 1, n) for n in shape], indexing="ij")
    bumps = ndimage.gaussian_filter(rng.standard_normal(shape), 6)
    return (x ** 2 + y ** 2 + z ** 2) < 0.6 + 8.0 * bumps


def phase_points(dev):
    """The five packaged point nets on the card, each on one batch of 16
    contexts at its ``meta.npoints`` (``extract_contexts`` over the
    surface-nets vertices of a seeded blob), against the port's CPU plain
    path on the same inputs: kNN indices equal, logits within the dense
    budget (median relative error < 3e-2, argmax flips < 3e-3, as
    tests/test_torch_pointnet.py holds them to flax). Per net: forward ms,
    the kNN part alone (distances, selection, gather), points per second,
    peak memory. Returns task -> forward ms."""
    import numpy as np
    import torch

    from syconn_tpu_torch.inference.points import (ContextPredictor, append_global_scalars,
                                                   extract_contexts)
    from syconn_tpu_torch.mesh.surface_nets import surface_net_mesh
    from syconn_tpu_torch.models.io import load_model, load_model_meta, packaged_model_path
    from syconn_tpu_torch.models.pointnet import knn_group, knn_indices

    _, verts, _ = surface_net_mesh(_blob_mask(), scale=(10, 10, 20))
    verts = verts.reshape(-1, 3)
    types = np.zeros(len(verts), np.int32)
    types[np.random.default_rng(3).random(len(verts)) < 0.1] = 1  # a few "mi" points
    out = {}
    for task in POINT_NETS:
        path = packaged_model_path(task)
        meta = load_model_meta(path)
        npoints = int(meta["npoints"])
        model, _ = load_model(path)
        ctx, _ = extract_contexts(verts, types, ctx_size_nm=float(meta.get("ctx_nm", 4000.0)),
                                  npoints=npoints, n_contexts=16, rng=np.random.default_rng(5))
        n_global = int(getattr(model, "n_global", 0))
        if n_global:
            s = np.random.default_rng(6).standard_normal(n_global).astype(np.float32)
            ctx = append_global_scalars(ctx, s)
        x_cpu = torch.from_numpy(np.ascontiguousarray(ctx))
        with torch.inference_mode():
            ref = model(x_cpu)
        pred = ContextPredictor(model, npoints=npoints, batch=16, device=dev)
        x = x_cpu.to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got = pred.forward(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        k = model._PointBackbone_0.k
        idx_card = knn_indices(x[..., :3], k).cpu()
        idx_cpu = knn_indices(x_cpu[..., :3], k)
        if not torch.equal(idx_card, idx_cpu):
            raise AssertionError(f"points {task}: kNN indices card != CPU on "
                                 f"{int((idx_card != idx_cpu).sum())} entries")
        lg = (got["logits"] if isinstance(got, dict) else got).float().cpu()
        lr = ref["logits"] if isinstance(ref, dict) else ref
        rel = (lg - lr).abs() / lr.abs().clamp_min(1e-2)
        med = float(rel.median())
        agree = float((lg.argmax(-1) == lr.argmax(-1)).float().mean())
        if not bool(torch.isfinite(lg).all()) or med >= 3e-2 or agree <= 1 - 3e-3:
            raise AssertionError(f"points {task}: card vs CPU median rel {med:.3g}, argmax "
                                 f"agreement {agree:.5f}")
        if isinstance(got, dict) and "embedding" in got:
            nrm = torch.linalg.vector_norm(got["embedding"].float(), dim=-1)
            if float((nrm - 1).abs().max()) > 1e-3:
                raise AssertionError(f"points {task}: embedding not unit-norm")
        fwd_ms = cuda_ms(lambda: pred.forward(x), warmup=2, reps=5, inner=4)
        feats = torch.randn(x.shape[:2] + (model._PointBackbone_0.widths[0],), device=dev,
                            dtype=torch.bfloat16)
        knn_ms = cuda_ms(lambda: knn_group(x[..., :3], feats, k), warmup=2, reps=5, inner=4)
        res = dict(task=task, batch=16, npoints=npoints, channels=int(x.shape[-1]),
                   forward_ms=fwd_ms, knn_ms=knn_ms, knn_stages=model._PointBackbone_0.knn_stages,
                   points_per_s=16 * npoints / (fwd_ms / 1e3), peak_bytes=int(peak),
                   median_rel=med, argmax_agreement=agree, max_abs_err=float((lg - lr).abs().max()))
        log(f"points forward {task} " + json.dumps(res))
        if task == "glia_pts":  # step 3's net: where its forward goes
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                pred.forward(x)
                torch.cuda.synchronize()
            top = [(e.key[:48], round(getattr(e, "device_time_total", 0.0) / 1e3, 4), e.count)
                   for e in sorted(prof.key_averages(),
                                   key=lambda e: -getattr(e, "device_time_total", 0.0))[:8]]
            log(f"points profile {task} device ms: " + json.dumps(top))
        out[task] = res
    return out


VIEW_NETS = {  # task -> (class, kwargs, input: a view stack or single views)
    "celltype": ("MultiViewCMN", dict(n_classes=8, widths=(16, 32, 64)), "stack"),
    "tnet": ("TripletCMN", dict(embed_dim=10, widths=(16, 32, 64)), "stack"),
    "axoness_semseg": ("ViewSemSegNet", dict(n_classes=3, widths=(16, 32, 64)), "single"),
    "glia": ("MultiViewCMN", dict(n_classes=2, widths=(16, 32, 64)), "stack"),
    "axoness_views": ("MultiViewCMN", dict(n_classes=3, widths=(16, 32, 64)), "stack"),
}
VIEW_SIZES = {"inference": ((128, 64), 8000.0), "config": ((256, 128), 8000.0)}


def _view_net(task):
    from syconn_tpu_torch.models import cmn
    from syconn_tpu_torch.models.io import init_model_params

    cls, kw, _ = VIEW_NETS[task]
    model = getattr(cmn, cls)(**kw)
    init_model_params(model, seed=0)
    return model.eval()


def phase_views(dev):
    """The renderer and the view nets on the card. The surface-nets mesh of
    the seeded blob is rendered at 64 of its vertices (PCA rotations from
    ``calc_rot_matrices``) at the inference functions' 128x64 and the config's 256x128,
    2 views a location: device ms per chunk of 16 locations (``cuda_ms`` of
    one chunk's transform, scatters and image), wall ms per chunk of a whole
    ``SplatRenderer.render`` (transfers and readback included), frames/s,
    vertices, peak bytes and a bytes bound (each vertex read once a frame,
    the z-buffer and index image written and read twice); the same frames
    rendered on the CPU: depth and index views equal. Each view net at the
    inference functions' widths (seed-initialised, as ``views.allow_untrained_models``
    runs them) on batches of 8 of the inference functions' views: forward ms (median
    ``cuda_ms``), logits card against CPU within the dense budget (median
    relative error < 3e-2, argmax flips < 2e-2 at random init), per-location
    embeddings unit-norm. Returns (net -> forward ms a batch, view size ->
    device ms a frame)."""
    import numpy as np
    import torch

    from syconn_tpu_torch.inference.views_infer import views_to_model_input
    from syconn_tpu_torch.mesh.surface_nets import surface_net_mesh
    from syconn_tpu_torch.proc.meshes import calc_rot_matrices
    from syconn_tpu_torch.render.raster import (SplatRenderer, _render_chunk, fused_columns,
                                                view_rotations)

    _, verts, _ = surface_net_mesh(_blob_mask(), scale=(10, 10, 20))
    verts = verts.reshape(-1, 3).astype(np.float32)
    locs = verts[np.random.default_rng(7).choice(len(verts), 64, replace=False)]
    frame_ms, views_in = {}, None
    for size, (ws, cw) in VIEW_SIZES.items():
        t0 = time.perf_counter()
        rots = calc_rot_matrices(locs, verts, cw)
        t_rot = time.perf_counter() - t0
        r = SplatRenderer(ws=ws, nb_views=2, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        st = {}
        depth, index = r.render(verts, locs, rots, cw, stats=st)
        peak = torch.cuda.max_memory_allocated() - base
        t0 = time.perf_counter()
        r.render(verts, locs, rots, cw)
        wall_chunk = (time.perf_counter() - t0) * 1e3 / 4
        vt = torch.from_numpy(verts).to(dev)
        cb = torch.from_numpy(locs[:16]).to(dev)
        rb = torch.from_numpy(np.stack([view_rotations(x, 2) for x in rots[:16]])).to(dev)
        window = torch.tensor(cw, dtype=torch.float32, device=dev)
        fused = torch.from_numpy(fused_columns(2)).to(dev)
        dev_chunk = cuda_ms(lambda: _render_chunk(vt, cb, rb, window, ws, fused),
                            warmup=2, reps=5, inner=4)
        frame_ms[size] = dev_chunk / 32
        d_cpu, i_cpu = SplatRenderer(ws=ws, nb_views=2, device="cpu").render(verts, locs, rots, cw)
        if not (np.array_equal(depth, d_cpu) and np.array_equal(index, i_cpu)):
            raise AssertionError(f"views {size}: card != CPU on "
                                 f"{int((depth != d_cpu).sum())} depth and "
                                 f"{int((index != i_cpu).sum())} index pixels")
        fg = float((index >= 0).mean())
        if fg <= 0:
            raise AssertionError(f"views {size}: nothing rendered")
        frames = 32
        bytes_moved = frames * (len(verts) * 12 + ws[0] * ws[1] * (4 * 2 + 4 * 2 + 1 + 4))
        log(f"views forward render {size} " + json.dumps(dict(
            ws=list(ws), comp_window=cw, locations=64, vertices=int(len(verts)),
            device_ms_per_chunk16=dev_chunk, wall_ms_per_chunk16=wall_chunk,
            frames_per_s=frames / (dev_chunk / 1e3), bound_ms_per_chunk16=bytes_moved / PEAK_BYTES
            * 1e3, bound_by="bytes", rotations_s=t_rot, peak_bytes=int(peak),
            foreground_share=fg, card_equals_cpu=True)))
        if size == "inference":
            v4 = np.full((64, 2, 4) + ws, 255, np.uint8)
            v4[:, :, 0] = depth
            views_in = views_to_model_input(v4).astype(np.float32)
    out = {}
    for task, (_, _, kind) in VIEW_NETS.items():
        model = _view_net(task)
        x_cpu = torch.from_numpy(np.ascontiguousarray(
            views_in[:8] if kind == "stack" else views_in[:4].reshape((8,) + views_in.shape[2:])))
        with torch.inference_mode():
            ref = model(x_cpu)
            model_d = model.to(dev)
            x = x_cpu.to(dev)
            torch.cuda.reset_peak_memory_stats()
            got = model_d(x).float().cpu()
            peak = torch.cuda.max_memory_allocated()
            fwd = cuda_ms(lambda: model_d(x), warmup=2, reps=5, inner=4)
        rel = (got - ref).abs() / ref.abs().clamp_min(1e-2)
        med = float(rel.median())
        flips = float((got.argmax(-1) != ref.argmax(-1)).float().mean())
        if not bool(torch.isfinite(got).all()) or med >= 3e-2 or flips >= 2e-2:
            raise AssertionError(f"views {task}: card vs CPU median rel {med:.3g}, argmax "
                                 f"flips {flips:.3g}")
        if task == "tnet" and float((torch.linalg.vector_norm(got, dim=-1) - 1).abs().max()) > 1e-3:
            raise AssertionError("views tnet: embeddings not unit-norm")
        log(f"views forward net {task} " + json.dumps(dict(
            batch=8, input=list(x.shape), cuda_ms=fwd, peak_bytes=int(peak), median_rel=med,
            argmax_flips=flips, max_abs_err=float((got - ref).abs().max()))))
        out[task] = fwd
    return out, frame_ms


def _component_sets(g):
    from syconn_tpu_torch.proc.graphs import component_lists

    return {tuple(c) for c in component_lists(g)}


def _attr_dicts(sd_path: str) -> dict:
    """Every attribute dict under a dataset directory, merged."""
    from syconn_tpu_torch.backend import AttributeDict

    out = {}
    for p in glob.glob(os.path.join(sd_path, "so_storage", "**", "attr_dict.pkl"),
                       recursive=True):
        out.update(AttributeDict(p, read_only=True, disable_locking=True).copy_intern())
    return out


def phase_slice_cells(dev, work: str, glia_forward_ms: float):
    """Steps 1 (its second call), 3, 4 and 5 through the working-directory
    configuration, on ``phase_slice_pipeline``'s working directory (its cell
    segmentation, datasets and pruned graph):

    * ``predict_myelin()`` (``start.py:327``; the myelin U-Net on the three
      conv kernels) into ``kd_myelin_path``;
    * step 3 in a copy with ``glia.prior_astrocyte_removal: True``:
      ``run_astrocyte_prediction_pts()`` on the card, then
      ``run_astrocyte_splitting()``; the neuron and astrocyte graphs
      partition the pruned graph's nodes, and on >= 32 sampled SVs the
      card's ``glia_probas`` equal the port's CPU run of the same driver
      within ``GLIA_ATOL``;
    * steps 4-5 in the original directory (the shipped
      ``prior_astrocyte_removal: False``): ``run_create_neuron_ssd()`` and
      ``run_skeleton_generation(map_myelin=True, cube_size=chunk)``; the SSD
      is not empty, each SSV's ``sv_ids`` are one component of the pruned
      graph, reverse-index lookups equal the mapping dict, every cell has a
      connected skeleton inside its bounding box (the slack of
      tests/test_skeleton.py) with one myelin entry per node, and every
      object went through the C++ TEASAR kernel.

    Returns the conv kernels' launches of ``predict_myelin``."""
    import shutil

    import numpy as np
    import torch

    from syconn_tpu_torch import global_params
    from syconn_tpu_torch.exec import exec_dense_prediction, exec_inference, exec_init
    from syconn_tpu_torch.exec import exec_skeleton
    from syconn_tpu_torch.handler.config import generate_default_conf
    from syconn_tpu_torch.inference.points import predict_glia_ssv
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.io.graph import load_svgraph
    from syconn_tpu_torch.ops.conv3d import LAUNCHES, reset_launch_counts
    from syconn_tpu_torch.reps.segmentation import SegmentationDataset
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset
    from syconn_tpu_torch.skeleton import sparsify, teasar
    from syconn_tpu_torch.utils.native import get_native

    wd = os.path.join(work, "pipeline_wd")
    global_params.wd = wd
    cfg = global_params.config
    shape = tuple(int(v) for v in ChunkedVolume.open(cfg.kd_seg_path).mag_shape(1))
    mvox = float(np.prod(shape)) / 1e6

    # step 1's second call: the myelin map that skeleton myelin mapping reads
    torch.cuda.synchronize()
    reset_launch_counts()
    st1 = exec_dense_prediction.predict_myelin(device=dev, show_progress=False)
    launches = dict(LAUNCHES)
    for k, per in PER_TILE["myelin"].items():
        if launches[k] <= 0 or launches[k] != st1["dispatches"] * per:
            raise AssertionError(f"cells myelin: {k} launched {launches[k]} times, expected "
                                 f"{st1['dispatches']} dispatches x {per}")
    log("slice cells myelin " + json.dumps(dict(
        seconds=st1["seconds"], mvox_per_s=st1["mvox_per_s"], dispatches=st1["dispatches"],
        launches=launches)))

    # step 3 in a copy: the SV dataset and the pruned graph, volumes in place
    pruned = load_svgraph(cfg.pruned_svgraph_path)
    wd3 = os.path.join(work, "cells_wd_astrocytes")
    generate_default_conf(wd3, scaling=(10, 10, 20), key_value_pairs=[
        ("glia", {"prior_astrocyte_removal": True})])
    shutil.copytree(os.path.join(wd, "svs_0"), os.path.join(wd3, "svs_0"))
    shutil.copy(cfg.pruned_svgraph_path, os.path.join(wd3, os.path.basename(
        cfg.pruned_svgraph_path)))
    wd3c = os.path.join(work, "cells_wd_astrocytes_cpu")
    shutil.copytree(wd3, wd3c)
    global_params.wd = wd3
    cfg3 = global_params.config
    if not cfg3.prior_astrocyte_removal:
        raise AssertionError("cells: the step-3 copy does not enable astrocyte removal")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st3 = {}
    exec_inference.run_astrocyte_prediction_pts(device=dev, stats=st3)
    t_pred = time.perf_counter() - t0
    split = exec_inference.run_astrocyte_splitting(device=dev)
    t_split = time.perf_counter() - t0 - t_pred
    gn = load_svgraph(cfg3.neuron_svgraph_path)
    ga = load_svgraph(cfg3.astrocyte_svgraph_path)
    nn_, na = set(gn["nodes"].tolist()), set(ga["nodes"].tolist())
    if nn_ & na or (nn_ | na) != set(pruned["nodes"].tolist()):
        raise AssertionError(f"cells: neuron ({len(nn_)}) and astrocyte ({len(na)}) graphs do "
                             f"not partition the pruned graph's {len(pruned['nodes'])} nodes")
    sd3 = SegmentationDataset("sv", working_dir=wd3)
    probas = dict(zip(sd3.ids.tolist(), np.asarray(sd3.load_numpy_data("glia_probas")).tolist()))
    sample = np.random.default_rng(17).choice(pruned["nodes"], size=min(40, len(
        pruned["nodes"])), replace=False).astype(np.uint64)
    if len(sample) < 32:
        raise AssertionError(f"cells: only {len(sample)} SVs to compare")
    global_params.wd = wd3c
    ssd_cpu = SuperSegmentationDataset(working_dir=wd3c, version="cpucheck",
                                       sv_mapping={int(s): [int(s)] for s in sample}, create=True)
    t0 = time.perf_counter()
    predict_glia_ssv(ssd=ssd_cpu, device="cpu")
    t_cpu = time.perf_counter() - t0
    sdc = SegmentationDataset("sv", working_dir=wd3c)
    diffs = [abs(sdc.get_segmentation_object(int(s)).lookup_in_attribute_dict("glia_probas")
                 - probas[int(s)]) for s in sample]
    if max(diffs) > GLIA_ATOL:
        raise AssertionError(f"cells: glia_probas card vs CPU differ by up to {max(diffs):.4g}")
    busy = st3["dispatches"] * glia_forward_ms / (t_pred * 1e3)
    log("slice cells astrocytes " + json.dumps(dict(
        seconds=t_pred, split_seconds=t_split, svs=st3["svs"], contexts=st3["contexts"],
        dispatches=st3["dispatches"], forward_ms=glia_forward_ms, busy_share=busy,
        neuron_svs=split["n_neuron_sv"], astrocyte_svs=split["n_glia_sv"],
        glia_probas_max=max(probas.values()), card_vs_cpu_max_abs=max(diffs),
        compared_svs=int(len(sample)), cpu_seconds=t_cpu)))

    # steps 4-5 in the original directory (the shipped default: no step 3)
    global_params.wd = wd
    cfg = global_params.config
    if cfg.prior_astrocyte_removal or os.path.isfile(cfg.neuron_svgraph_path):
        raise AssertionError("cells: the original directory has astrocyte removal on")
    st4 = {}
    ssd = exec_init.run_create_neuron_ssd(device=dev, stats=st4)
    ssv_ids = ssd.ssv_ids
    attrs = _attr_dicts(ssd.path)
    comps = _component_sets(pruned)
    if len(ssv_ids) == 0 or len(ssv_ids) != len(comps) or sorted(attrs) != ssv_ids.tolist():
        raise AssertionError(f"cells: {len(ssv_ids)} SSVs for {len(comps)} components")
    for i in ssv_ids.tolist():
        if tuple(int(s) for s in attrs[i]["sv_ids"]) not in comps:
            raise AssertionError(f"cells: SSV {i}'s sv_ids are not one pruned component")
    svs = np.concatenate([np.asarray(v, np.uint64) for v in ssd.mapping_dict.values()])
    want = np.concatenate([np.full(len(v), k, np.uint64) for k, v in ssd.mapping_dict.items()])
    if not np.array_equal(SuperSegmentationDataset(working_dir=wd).sv2ssv_ids(svs), want):
        raise AssertionError("cells: reverse-index lookups != the mapping dict")
    log("slice cells ssd " + json.dumps(dict(st4, svs=int(len(svs)))))

    if get_native() is None:
        raise AssertionError("cells: the C++ host library (TEASAR) did not build")
    teasar.reset_routes()
    t0 = time.perf_counter()
    st5 = {}
    n = exec_skeleton.run_skeleton_generation(map_myelin=True, cube_size=STEP2_CHUNK,
                                              device=dev, stats=st5)
    t5 = time.perf_counter() - t0
    routes = dict(teasar.ROUTES)
    if routes["native"] == 0 or routes["python"] != 0:
        raise AssertionError(f"cells: TEASAR routes {routes}: the C++ kernel must take every "
                             f"object")
    if n != len(ssv_ids):
        raise AssertionError(f"cells: {n} skeletons for {len(ssv_ids)} cells")
    n_nodes = n_myelin = 0
    for i in ssv_ids.tolist():
        sso = ssd.get_super_segmentation_object(i)
        if not sso.load_skeleton():
            raise AssertionError(f"cells: SSV {i} has no skeleton")
        sk = sso.skeleton
        bb = np.asarray(attrs[i]["bounding_box"])
        nodes = np.asarray(sk["nodes"])
        if not (len(nodes) and sparsify.skeleton_to_nx(sk).is_connected()
                and bool((nodes >= bb[0] - 8).all()) and bool((nodes <= bb[1] + 8).all())
                and len(sk["myelin"]) == len(nodes) == len(sk["myelin_avg10000"])):
            raise AssertionError(f"cells: SSV {i}'s skeleton is empty, split, outside its box "
                                 f"or without one myelin entry per node")
        n_nodes += len(nodes)
        n_myelin += int(np.sum(sk["myelin"]))
    log("slice cells skeletons " + json.dumps(dict(
        st5, seconds=t5, mvox_per_s=mvox / t5, nodes=n_nodes, myelin_nodes=n_myelin,
        routes=routes)))
    global_params.wd = None
    return launches


def phase_slice_synapses(dev, work: str):
    """Steps 6 and 6.5 on ``phase_slice_pipeline``'s working directory (its
    cells, SSD and skeletons from ``phase_slice_cells``), as
    ``start.py:355-366`` runs them: ``syntype_avail: True`` in the config,
    ``predict_synapsetype()`` (the syntype U-Net on the three conv kernels)
    into ``kd_asym_path``/``kd_sym_path``, ``run_syn_generation()`` whole
    (the contact kernel, then agglomeration into ``syn_ssv``, organelle
    mapping, ``syn_prob`` and the cells' synapse lists) and
    ``run_cs_ssv_generation()``. Checks: ``syn_ssv`` and ``cs_ssv`` not
    empty, ids 1..n in ``(partners, rep_coord)`` order, partners two distinct
    SSVs of the SSD, ``cs_ids`` ids of the fragment dataset, ``syn_sign``
    -1 exactly where the stored ``sym_prop / (asym_prop + sym_prop)``
    exceeds ``sym_thresh``, every SSV's ``syn_ssv`` the inversion of the
    partners, one row per object in the mapping caches, ``syn_prob`` in
    [0, 1], sampled meshes not empty. Returns the kernels' launches."""
    import numpy as np
    import torch

    from syconn_tpu_torch import global_params
    from syconn_tpu_torch.exec import exec_dense_prediction, exec_syns
    from syconn_tpu_torch.handler.config import generate_default_conf
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.ops.conv3d import LAUNCHES, reset_launch_counts
    from syconn_tpu_torch.reps.segmentation import SegmentationDataset
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset

    wd = os.path.join(work, "pipeline_wd")
    generate_default_conf(wd, scaling=(10, 10, 20), key_value_pairs=[("syntype_avail", True)],
                          force_overwrite=True)
    global_params.wd = wd
    cfg = global_params.config
    cfg._parse_config()
    if not cfg.syntype_available:
        raise AssertionError("synapses: syntype_avail did not reach the configuration")
    shape = tuple(int(v) for v in ChunkedVolume.open(cfg.kd_seg_path).mag_shape(1))
    mvox = float(np.prod(shape)) / 1e6

    torch.cuda.synchronize()
    reset_launch_counts()
    st1 = exec_dense_prediction.predict_synapsetype(device=dev, show_progress=False)
    launches = dict(LAUNCHES)
    for k, per in PER_TILE["syntype"].items():
        if launches[k] <= 0 or launches[k] != st1["dispatches"] * per:
            raise AssertionError(f"synapses syntype: {k} launched {launches[k]} times, "
                                 f"expected {st1['dispatches']} dispatches x {per}")
    for t in ("asym", "sym"):
        out = ChunkedVolume.open(getattr(cfg, f"kd_{t}_path")).load_raw(size=shape)
        if int(out.max()) == int(out.min()):
            raise AssertionError(f"synapses syntype: {t} map is constant")
    log("slice synapses predict_synapsetype " + json.dumps(dict(
        seconds=st1["seconds"], mvox_per_s=st1["mvox_per_s"], dispatches=st1["dispatches"],
        conv_launches={k: launches[k] for k in PER_TILE["syntype"]})))

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = exec_syns.run_syn_generation(chunk_size=STEP2_CHUNK, overwrite=True, device=dev)
    t_syn = time.perf_counter() - t0
    launches["detect_cs_columns"] = LAUNCHES["detect_cs_columns"]
    if not (launches["detect_cs_columns"] == res["stats"]["dispatched"] > 0):
        raise AssertionError(f"synapses: contact kernel launched {launches['detect_cs_columns']}"
                             f" times for {res['stats']['dispatched']} chunks")
    stages = res["stages"]
    log("slice synapses extract_contact_sites " + json.dumps(dict(
        seconds=stages["extract_contact_sites"], mvox_per_s=mvox / stages["extract_contact_sites"],
        n_cs=res["n_cs"], n_syn=res["n_syn"], kernel_launches=launches["detect_cs_columns"])))
    log("slice synapses combine_and_split_syn " + json.dumps(dict(
        seconds=stages["combine_and_split_syn"], partner_pairs=res["n_pairs"],
        objects=res["n_syn_ssv"])))
    for name in ("map_objects_from_synssv_partners", "classify_synssv_objects",
                 "map_synssv_objects", "dataset_analysis"):
        log(f"slice synapses {name} " + json.dumps(dict(seconds=stages[name])))
    t0 = time.perf_counter()
    res_cs = exec_syns.run_cs_ssv_generation(device=dev)
    log("slice synapses combine_and_split_cs " + json.dumps(dict(
        seconds=time.perf_counter() - t0, partner_pairs=res_cs["n_pairs"],
        objects=res_cs["n_cs_ssv"])))
    log(f"slice synapses run_syn_generation total {t_syn:.3f} s")

    ssd = SuperSegmentationDataset(working_dir=wd)
    ssv_ids = set(int(i) for i in ssd.ssv_ids)
    sym_thresh = float(cfg["cell_objects"]["sym_thresh"])
    counts = {}
    for t, frag in (("syn_ssv", "syn"), ("cs_ssv", "cs")):
        sd = SegmentationDataset(t, working_dir=wd)
        n = len(sd.ids)
        partners = sd.load_numpy_data("neuron_partners")
        reps = np.asarray(sd.rep_coords)
        order = sorted(range(n), key=lambda i: (int(partners[i, 0]), int(partners[i, 1]),
                                                tuple(reps[i])))
        if n == 0 or sd.ids.tolist() != list(range(1, n + 1)) or order != list(range(n)):
            raise AssertionError(f"synapses: {t} has {n} objects, ids not 1..n in (partners, "
                                 f"rep_coord) order")
        if not all(a != b and a in ssv_ids and b in ssv_ids for a, b in partners.tolist()):
            raise AssertionError(f"synapses: {t} partners are not two distinct SSVs")
        frag_ids = set(SegmentationDataset(frag, working_dir=wd).ids.tolist())
        attrs = _attr_dicts(sd.path)
        if sorted(attrs) != sd.ids.tolist() or not all(
                set(np.asarray(a["cs_ids"]).tolist()) <= frag_ids for a in attrs.values()):
            raise AssertionError(f"synapses: {t} cs_ids are not ids of {frag}")
        counts[t] = n
        if t != "syn_ssv":
            continue
        asym, sym = sd.load_numpy_data("asym_prop"), sd.load_numpy_data("sym_prop")
        denom = asym + sym
        want = np.where((denom > 0) & (sym / np.where(denom > 0, denom, 1) > sym_thresh), -1, 1)
        if not np.array_equal(sd.load_numpy_data("syn_sign"), want):
            raise AssertionError("synapses: syn_sign != -1 exactly where the symmetric ratio "
                                 "exceeds sym_thresh")
        for co in ("mi", "vc"):
            for key in (f"n_{co}_objs", f"n_{co}_vxs", f"min_dst_{co}_nm"):
                for j in (0, 1):
                    v = sd.load_numpy_data(f"{key}_{j}")
                    if v is None or len(v) != n:
                        raise AssertionError(f"synapses: {key}_{j} has no row per object")
        prob = sd.load_numpy_data("syn_prob")
        if len(prob) != n or not (prob.min() >= 0 and prob.max() <= 1):
            raise AssertionError("synapses: syn_prob outside [0, 1]")
        inv = {i: [] for i in ssv_ids}
        for sid, (a, b) in zip(sd.ids.tolist(), partners.tolist()):
            inv[a].append(sid)
            inv[b].append(sid)
        for i in ssv_ids:
            got = ssd.get_super_segmentation_object(i).lookup_in_attribute_dict("syn_ssv")
            if got is None or np.asarray(got).tolist() != sorted(inv[i]):
                raise AssertionError(f"synapses: SSV {i}'s syn_ssv != the partners' inversion")
        rng = np.random.default_rng(23)
        for oid in rng.choice(sd.ids, size=min(8, n), replace=False).tolist():
            mesh = sd.get_segmentation_object(int(oid)).mesh
            if mesh is None or len(mesh[0]) == 0 or not np.isfinite(mesh[1]).all():
                raise AssertionError(f"synapses: syn_ssv {oid} has no mesh")
        counts["syn_sign_negative"] = int((want < 0).sum())
        counts["syn_prob_mean"] = float(prob.mean())
        counts["cells_with_synapses"] = sum(1 for v in inv.values() if v)
    log("slice synapses datasets " + json.dumps(counts))
    global_params.wd = None
    return launches


# card against CPU on the step 7-9 predictions (chip_smoke.py and
# tests/test_torch_kernels_cuda.py): node and vertex label agreement, and the
# embedding's absolute tolerance
LABEL_AGREEMENT = 0.98
EMBED_ATOL = 1e-3


def phase_slice_morphology(dev, work: str, forward_ms: dict):
    """Steps 7-9 and the export on the same working directory, as
    ``start.py:367-388`` runs them: ``run_semsegaxoness_prediction()``,
    ``run_semsegspiness_prediction()``, ``run_spinehead_volume_calc()``,
    ``run_morphology_embedding()``,
    ``run_celltype_prediction()`` and ``run_matrix_export()``, the nets on
    the card. Checks: every cell with a skeleton has ``axoness``,
    ``axoness_avg10000`` and ``spiness`` per node and ``*_vertex_labels``
    per mesh vertex; ``celltype_cnn_e3`` in [0, 8), its certainty in [0, 1];
    ``latent_morph`` finite of width ``ndim_embedding``; ``spinehead_vol``
    one non-negative entry per ``syn_ssv``; the CSV one row per ``syn_prob
    >= thresh_synssv_proba``, the NPZ the same rows. Card against CPU: the
    four predictions again with ``device="cpu"`` on >= 8 cells in a copy of the
    directory taken before step 7: label agreement >= ``LABEL_AGREEMENT``,
    celltype logits within the dense budget, embeddings within
    ``EMBED_ATOL``."""
    import shutil

    import numpy as np
    import torch

    from syconn_tpu_torch import global_params
    from syconn_tpu_torch.exec import exec_inference, exec_syns
    from syconn_tpu_torch.inference import points
    from syconn_tpu_torch.reps.segmentation import SegmentationDataset
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset

    wd = os.path.join(work, "pipeline_wd")
    global_params.wd = wd
    cfg = global_params.config
    ssd = SuperSegmentationDataset(working_dir=wd)
    ssv_ids = [int(i) for i in ssd.ssv_ids]
    # the CPU copy: the datasets the predictions read, before step 7 writes
    wc = os.path.join(work, "morphology_wd_cpu")
    os.makedirs(wc)
    shutil.copy(os.path.join(wd, "config.yml"), wc)
    for d in ("ssv_0", "svs_0", "mis_0", "vcs_0", "syn_ssvs_0"):
        shutil.copytree(os.path.join(wd, d), os.path.join(wc, d))
    sample = [int(i) for i in np.random.default_rng(29).choice(ssv_ids, size=min(10, len(
        ssv_ids)), replace=False)]
    if len(sample) < 8:
        raise AssertionError(f"morphology: only {len(sample)} cells to compare")

    def net_stage(name, fn, task):
        torch.cuda.synchronize()
        st = {}
        fn(device=dev, stats=st)
        busy = st["dispatches"] * forward_ms[task] / (st["seconds"] * 1e3)
        log(f"slice morphology {name} " + json.dumps(dict(
            seconds=st["seconds"], cells=st["cells"], predicted=st["predicted"],
            contexts=st["contexts"], dispatches=st["dispatches"], npoints=st["npoints"],
            forward_ms=forward_ms[task], busy_share=busy)))

    net_stage("run_semsegaxoness_prediction", exec_inference.run_semsegaxoness_prediction,
              "compartment_pts")
    net_stage("run_semsegspiness_prediction", exec_inference.run_semsegspiness_prediction,
              "spiness")
    sd_syn = SegmentationDataset("syn_ssv", working_dir=wd)
    st = {}
    t0 = time.perf_counter()
    shv = exec_syns.run_spinehead_volume_calc(device=dev, stats=st)
    log("slice morphology run_spinehead_volume_calc " + json.dumps(dict(
        st, seconds=time.perf_counter() - t0, synapses=int(len(sd_syn.ids)),
        max_um3=float(shv.max()) if len(shv) else 0.0)))
    if len(shv) != len(sd_syn.ids) or (shv < 0).any():
        raise AssertionError("morphology: spinehead_vol is not one non-negative entry per "
                             "syn_ssv")
    net_stage("run_morphology_embedding", exec_inference.run_morphology_embedding, "tnet_pts")
    net_stage("run_celltype_prediction", exec_inference.run_celltype_prediction,
              "celltype_pts")
    t0 = time.perf_counter()
    csv = exec_syns.run_matrix_export(device=dev)
    prob = SegmentationDataset("syn_ssv", working_dir=wd).load_numpy_data("syn_prob")
    n_rows = int((prob >= float(cfg["cell_objects"]["thresh_synssv_proba"])).sum())
    with open(csv) as f:
        lines = f.read().strip().split("\n")
    with np.load(csv[:-4] + ".npz") as z:
        npz_rows = [len(z[k]) for k in z.files]
        npz_ids = z["ids"].tolist()
    csv_ids = [int(ln.split(",")[0]) for ln in lines[1:]]
    if len(lines) - 1 != n_rows or set(npz_rows) != {n_rows} or csv_ids != npz_ids:
        raise AssertionError(f"morphology: the matrix has {len(lines) - 1} CSV rows and NPZ "
                             f"rows {set(npz_rows)} for {n_rows} synapses above threshold")
    log("slice morphology run_matrix_export " + json.dumps(dict(
        seconds=time.perf_counter() - t0, rows=n_rows, synapses=int(len(prob)))))

    # outputs per cell
    ndim = int(cfg["tcmn"]["ndim_embedding"])
    attrs = _attr_dicts(ssd.path)
    for i in ssv_ids:
        sso = ssd.get_super_segmentation_object(i)
        a = attrs[i]
        if sso.load_skeleton():
            sk = sso.skeleton
            n_nodes = len(sk["nodes"])
            n_vert = len(sso.load_mesh("sv")[1]) // 3
            if not all(len(sk.get(k, [])) == n_nodes
                       for k in ("axoness", "axoness_avg10000", "spiness")) or not all(
                    len(a.get(f"{k}_vertex_labels", [])) == n_vert for k in ("axoness", "spiness")):
                raise AssertionError(f"morphology: SSV {i} lacks per-node or per-vertex labels")
        z = np.asarray(a.get("latent_morph", []))
        if not (0 <= a.get("celltype_cnn_e3", -1) < 8 and 0 <= a["celltype_cnn_e3_certainty"] <= 1
                and z.shape == (ndim,) and np.isfinite(z).all()):
            raise AssertionError(f"morphology: SSV {i}'s cell type or embedding is malformed")

    # card against CPU on the sample, in the copy
    global_params.wd = wc
    cfg_c = global_params.config
    ssd_c = SuperSegmentationDataset(working_dir=wc)
    t0 = time.perf_counter()
    points.predict_compartments_ssd(ssd=ssd_c, ssv_ids=sample, skel_key="axoness", n_classes=3,
                                    device="cpu")
    points.predict_compartments_ssd(ssd=ssd_c, ssv_ids=sample, skel_key="spiness", n_classes=4,
                                    mpath=cfg_c.mpath_spiness, device="cpu")
    points.infere_cell_morphology_ssd(ssd=ssd_c, ssv_ids=sample, device="cpu")
    points.predict_celltype_ssd(ssd=ssd_c, ssv_ids=sample, device="cpu")
    t_cpu = time.perf_counter() - t0
    attrs_c = _attr_dicts(ssd_c.path)
    agree = {k: [] for k in ("axoness", "spiness", "axoness_vertex_labels",
                             "spiness_vertex_labels")}
    rel_med, flips, emb_err, ct_equal = [], [], [], 0
    for i in sample:
        a, c = attrs[i], attrs_c[i]
        s_card = ssd.get_super_segmentation_object(i)
        s_cpu = ssd_c.get_super_segmentation_object(i)
        if s_card.load_skeleton() and s_cpu.load_skeleton():
            for k in ("axoness", "spiness"):
                agree[k].append(float(np.mean(s_card.skeleton[k] == s_cpu.skeleton[k])))
        for k in ("axoness_vertex_labels", "spiness_vertex_labels"):
            if k in a:
                agree[k].append(float(np.mean(np.asarray(a[k]) == np.asarray(c[k]))))
        lg, lr = (torch.from_numpy(np.asarray(x[ "celltype_cnn_e3_probas"], np.float32))
                  for x in (a, c))
        rel_med.append(float(((lg - lr).abs() / lr.abs().clamp_min(1e-2)).median()))
        flips.append(float((lg.argmax(-1) != lr.argmax(-1)).float().mean()))
        emb_err.append(float(np.abs(np.asarray(a["latent_morph"]) -
                                    np.asarray(c["latent_morph"])).max()))
        ct_equal += int(a["celltype_cnn_e3"] == c["celltype_cnn_e3"])
    worst = {k: min(v) if v else None for k, v in agree.items()}
    log("slice morphology card_vs_cpu " + json.dumps(dict(
        cells=len(sample), label_agreement_min=worst, celltype_equal=ct_equal,
        celltype_logits_median_rel_max=max(rel_med), celltype_argmax_flips_max=max(flips),
        embedding_max_abs=max(emb_err), cpu_seconds=t_cpu)))
    if any(v is None or v < LABEL_AGREEMENT for v in worst.values()):
        raise AssertionError(f"morphology: card vs CPU label agreement {worst} below "
                             f"{LABEL_AGREEMENT}")
    if max(rel_med) >= 3e-2 or max(flips) >= 3e-3:
        raise AssertionError(f"morphology: celltype logits card vs CPU median rel "
                             f"{max(rel_med):.3g}, argmax flips {max(flips):.3g}")
    if max(emb_err) > EMBED_ATOL:
        raise AssertionError(f"morphology: embeddings card vs CPU differ by {max(emb_err):.3g}")
    global_params.wd = None


VIEW_CELLS_CPU = 5


def phase_slice_views(dev, work: str, forward_ms: dict, frame_ms: dict):
    """The view route of steps 7-9 (``start.py --use_views``) on the
    pipeline's cells, in a working directory with a copy of its datasets and
    of its configuration with ``use_point_models: False``,
    ``views.allow_untrained_models: True`` (the view nets seed-initialised
    and persisted at first use) and ``compartments.view_scalar_avg: True``:
    ``run_neuron_rendering()``, ``run_semsegaxoness_prediction()``,
    ``run_morphology_embedding()``, ``run_celltype_prediction()``, then
    ``run_astrocyte_rendering()`` and ``gliapred_sso_views`` on the
    ``gliapred`` components. Per stage: seconds, cells, locations, frames,
    render seconds and calls, forward dispatches and the card's busy share
    (rendered frames x device ms a frame + dispatches x the mean forward ms
    of the stage's nets, over the wall); the cell-type stage once more under
    ``torch.profiler``: its device time over its wall. Checks: every cell has
    its stored views (``(id, "raw")``, 4 channels at the config's 256x128) and
    ``view_locations``, vertex labels in [0, 3] per mesh vertex, node labels in
    [0, 3], an embedding of norm <= 1 (the mean of unit-norm ones), a cell type
    in [0, 8) with its certainty in [0, 1], glia probabilities in [0, 1]. Card
    against CPU on ``VIEW_CELLS_CPU`` cells in a copy of the datasets: stored
    and index views equal, vertex and node labels agree >= ``LABEL_AGREEMENT``,
    celltype logits within the dense budget, embeddings within ``EMBED_ATOL``.
    The view route launches none of the four kernels; the counts are read after
    it.
    """
    import numpy as np
    import torch

    from syconn_tpu_torch import global_params
    from syconn_tpu_torch.exec import exec_inference, exec_render
    from syconn_tpu_torch.handler.config import generate_default_conf
    from syconn_tpu_torch.inference import views_infer
    from syconn_tpu_torch.ops.conv3d import LAUNCHES, reset_launch_counts
    from syconn_tpu_torch.render import views as rviews
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset
    from syconn_tpu_torch.reps.views import ViewContainer

    src = os.path.join(work, "pipeline_wd")
    wd = os.path.join(work, "views_wd")
    generate_default_conf(wd, scaling=(10, 10, 20), key_value_pairs=[
        ("syntype_avail", True), ("use_point_models", False),
        ("views", {"allow_untrained_models": True}), ("compartments", {"view_scalar_avg": True})])
    for d in ("ssv_0", "svs_0", "mis_0", "vcs_0", "syn_ssvs_0"):
        if os.path.isdir(os.path.join(src, d)):
            shutil.copytree(os.path.join(src, d), os.path.join(wd, d))
    global_params.wd = src
    pruned = global_params.config.pruned_svgraph_path
    global_params.wd = wd
    cfg = global_params.config
    shutil.copy(pruned, cfg.pruned_svgraph_path)
    if cfg.use_point_models or not cfg["views"]["allow_untrained_models"]:
        raise AssertionError("views: the configuration did not take the view route")
    wc = os.path.join(work, "views_wd_cpu")
    shutil.copytree(wd, wc)
    ssd = SuperSegmentationDataset(working_dir=wd)
    ssv_ids = [int(i) for i in ssd.ssv_ids]
    ws, nv = tuple(cfg["views"]["view_properties"]["ws"]), int(
        cfg["views"]["view_properties"]["nb_views"])
    size_of = {(128, 64): "inference", (256, 128): "config"}

    def stage(name, fn, nets, frame_size):
        torch.cuda.synchronize()
        st = {}
        t0 = time.perf_counter()
        n = fn(device=dev, stats=st)
        wall = time.perf_counter() - t0
        dev_ms = st.get("render_frames", 0) * frame_ms[frame_size] + sum(
            st.get("dispatches", 0) * forward_ms[t] for t in nets) / max(len(nets), 1)
        log(f"slice views {name} " + json.dumps(dict(
            seconds=wall, cells=n, locations=st.get("locations", 0),
            frames=st.get("frames", st.get("render_frames", 0)),
            render_calls=st.get("render_calls", 0), render_frames=st.get("render_frames", 0),
            render_seconds=st.get("render_seconds", 0.0), dispatches=st.get("dispatches", 0),
            forward_seconds=st.get("forward_seconds", 0.0), busy_share=dev_ms / (wall * 1e3))))
        return st

    reset_launch_counts()
    stage("run_neuron_rendering", exec_render.run_neuron_rendering, [], size_of[ws])
    # the semseg and the per-location axoness CMN run in one stage; their
    # frames are the inference functions' 128x64
    stage("run_semsegaxoness_prediction", exec_inference.run_semsegaxoness_prediction,
          ["axoness_semseg", "axoness_views"], "inference")
    stage("run_morphology_embedding", exec_inference.run_morphology_embedding, ["tnet"],
          "inference")
    stage("run_celltype_prediction", exec_inference.run_celltype_prediction, ["celltype"],
          "inference")
    # the same stage again under the profiler: the card's own busy time
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exec_inference.run_celltype_prediction(device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    top = [(e.key[:40], round(getattr(e, "self_device_time_total", 0.0) / 1e3, 3), e.count)
           for e in sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:8]]
    log("slice views profile run_celltype_prediction " + json.dumps(dict(
        seconds=wall, device_ms=dev_us / 1e3, busy_share=dev_us / 1e3 / (wall * 1e3),
        top_device_ms=top)))
    stage("run_astrocyte_rendering", exec_render.run_astrocyte_rendering, [], size_of[ws])
    gssd = SuperSegmentationDataset(working_dir=wd, version="gliapred")
    st = {}
    t0 = time.perf_counter()
    glia = {int(i): views_infer.gliapred_sso_views(gssd.get_super_segmentation_object(int(i)),
                                                   device=dev, stats=st) for i in gssd.ssv_ids}
    wall = time.perf_counter() - t0
    log("slice views gliapred_sso_views " + json.dumps(dict(
        seconds=wall, cells=len(glia), locations=st.get("locations", 0),
        frames=st.get("frames", 0), render_seconds=st.get("render_seconds", 0.0),
        dispatches=st.get("dispatches", 0), busy_share=(
            st.get("render_frames", 0) * frame_ms["inference"]
            + st.get("dispatches", 0) * forward_ms["glia"]) / (wall * 1e3))))
    torch.cuda.synchronize()
    log("slice views kernel launches " + json.dumps(dict(LAUNCHES)))
    if not all(0.0 <= p <= 1.0 for p in glia.values()) or not glia:
        raise AssertionError("views: glia probabilities outside [0, 1]")

    # outputs per cell
    ndim = int(cfg["tcmn"]["ndim_embedding"])
    attrs = _attr_dicts(ssd.path)
    for i in ssv_ids:
        sso = ssd.get_super_segmentation_object(i)
        a = attrs[i]
        views = ViewContainer(sso.ssv_dir).load_views((i, "raw"))
        locs = np.asarray(a.get("view_locations", np.zeros((0, 3))))
        if views is None or views.shape != (len(locs), nv, 4) + ws or len(locs) == 0:
            raise AssertionError(f"views: SSV {i} lacks its stored views or locations")
        vl = np.asarray(a.get("axoness_vertex_labels", []))
        if len(vl) != len(sso.load_mesh("sv")[1]) // 3 or vl.min() < 0 or vl.max() > 3:
            raise AssertionError(f"views: SSV {i}'s vertex labels are malformed")
        if sso.load_skeleton():
            for k in ("axoness", "axoness_avg10000"):
                lab = np.asarray(sso.skeleton.get(k, []))
                if len(lab) != len(sso.skeleton["nodes"]) or lab.min() < 0 or lab.max() > 3:
                    raise AssertionError(f"views: SSV {i}'s node labels {k} are malformed")
        z = np.asarray(a.get("latent_morph", []))
        if not (z.shape == (ndim,) and np.isfinite(z).all() and np.linalg.norm(z) <= 1 + 1e-5
                and 0 <= a.get("celltype_cnn_e3", -1) < 8
                and 0 <= a["celltype_cnn_e3_certainty"] <= 1):
            raise AssertionError(f"views: SSV {i}'s cell type or embedding is malformed")

    # card against CPU on a sample, in the copy taken before the first stage
    shutil.copytree(os.path.join(wd, "models"), os.path.join(wc, "models"))
    sample = [int(i) for i in np.random.default_rng(41).choice(
        ssv_ids, size=min(VIEW_CELLS_CPU, len(ssv_ids)), replace=False)]
    global_params.wd = wc
    ssd_c = SuperSegmentationDataset(working_dir=wc)
    agree, rel_med, flips, emb_err, ct_equal = [], [], [], [], 0
    t0 = time.perf_counter()
    for i in sample:
        s_cpu = ssd_c.get_super_segmentation_object(i)
        v_cpu, l_cpu = rviews.render_sampled_sso(s_cpu, device="cpu")
        s_card = ssd.get_super_segmentation_object(i)
        if not (np.array_equal(v_cpu, ViewContainer(s_card.ssv_dir).load_views((i, "raw")))
                and np.array_equal(l_cpu, attrs[i]["view_locations"])):
            raise AssertionError(f"views: SSV {i}'s stored views differ from the CPU's")
        pts = np.asarray(attrs[i]["view_locations"][:4])
        kw = dict(ws=(128, 64), nb_views=2, comp_window=40960.0)
        if not np.array_equal(rviews.render_sso_coords_index_views(s_cpu, pts, device="cpu", **kw),
                              rviews.render_sso_coords_index_views(s_card, pts, device=dev, **kw)):
            raise AssertionError(f"views: SSV {i}'s index views card != CPU")
        views_infer.semseg_of_sso_views(s_cpu, device="cpu")
        views_infer.celltype_of_sso_views(s_cpu, device="cpu")
        views_infer.view_embedding_of_sso(s_cpu, device="cpu")
        c = s_cpu.load_attr_dict()
        a = attrs[i]
        agree.append(float(np.mean(np.asarray(a["axoness_vertex_labels"]) ==
                                   np.asarray(c["axoness_vertex_labels"]))))
        if s_card.load_skeleton() and s_cpu.load_skeleton():
            agree.append(float(np.mean(s_card.skeleton["axoness"] == s_cpu.skeleton["axoness"])))
        lg, lr = (torch.from_numpy(np.asarray(x["celltype_cnn_e3_probas"], np.float32))
                  for x in (a, c))
        rel_med.append(float(((lg - lr).abs() / lr.abs().clamp_min(1e-2)).median()))
        flips.append(float((lg.argmax(-1) != lr.argmax(-1)).float().mean()))
        emb_err.append(float(np.abs(np.asarray(a["latent_morph"]) -
                                    np.asarray(c["latent_morph"])).max()))
        ct_equal += int(a["celltype_cnn_e3"] == c["celltype_cnn_e3"])
    log("slice views card_vs_cpu " + json.dumps(dict(
        cells=len(sample), views_equal=True, index_views_equal=True,
        label_agreement_min=min(agree), celltype_equal=ct_equal,
        celltype_logits_median_rel_max=max(rel_med), celltype_argmax_flips_max=max(flips),
        embedding_max_abs=max(emb_err), cpu_seconds=time.perf_counter() - t0)))
    if min(agree) < LABEL_AGREEMENT:
        raise AssertionError(f"views: card vs CPU label agreement {min(agree)} below "
                             f"{LABEL_AGREEMENT}")
    if max(rel_med) >= 3e-2 or max(flips) >= 2e-2:
        raise AssertionError(f"views: celltype logits card vs CPU median rel {max(rel_med):.3g}, "
                             f"argmax flips {max(flips):.3g}")
    if max(emb_err) > EMBED_ATOL:
        raise AssertionError(f"views: embeddings card vs CPU differ by {max(emb_err):.3g}")
    global_params.wd = None


# ---------------------------------------------------------------- training
# the slice training phase (models/train.py and cnn/): a seeded toy world
# (start.py's default world generator) in its own working directory
TRAIN_WORLD = dict(shape=(192, 192, 96), n_cells=5, svs_per_cell=3, seed=3)
TRAIN_STEPS = 20
TRAIN_WARMUP = 3  # steps left out of the median (cuDNN plans, allocator)
# start.py --train_models' organelles override (syconn_tpu/examples/start.py:292-293)
START_OVERRIDE = dict(features=(32, 64), strides=((2, 2, 2),), patch=(2, 2, 2))
# card against CPU, one step from the same init and batch: the loss agrees
# within this relative tolerance (the models compute in bf16; the CPU
# parity tests against the JAX package measure ~3e-4 between the packages)
STEP_LOSS_RTOL = 1e-2
POINT_STEP = dict(npoints=2048, batch=8)
VIEW_STEP = dict(ws=(128, 64), nb_views=2, batch=16, widths=(16, 32, 64))


class _StepRecorder:
    """Wraps ``models.train``'s step factories while a trainer runs: each
    step is timed between CUDA events and on the host clock (the card
    synchronised before and after, so the host's own work between steps is
    the batch sampling), and its loss kept."""

    def __init__(self):
        self.events, self.walls, self.gaps, self.losses = [], [], [], []

    def __enter__(self):
        import torch

        from syconn_tpu_torch.models import train as mtrain

        self._mod, self._orig = mtrain, {}
        last = [None]

        def wrap(factory):
            def make(*a, **kw):
                fn = factory(*a, **kw)

                def step(state, *xs):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if last[0] is not None:
                        self.gaps.append(t0 - last[0])
                    a_ev = torch.cuda.Event(enable_timing=True)
                    b_ev = torch.cuda.Event(enable_timing=True)
                    a_ev.record()
                    state, m = fn(state, *xs)
                    b_ev.record()
                    torch.cuda.synchronize()
                    last[0] = time.perf_counter()
                    self.walls.append(last[0] - t0)
                    self.events.append((a_ev, b_ev))
                    self.losses.append(float(m["loss"]))
                    return state, m

                return step

            return make

        for name in ("make_train_step", "make_class_train_step", "make_triplet_train_step"):
            self._orig[name] = getattr(mtrain, name)
            setattr(mtrain, name, wrap(self._orig[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self._mod, name, fn)

    def summary(self, samples_per_step: int, voxels_per_sample: int = 0) -> dict:
        import numpy as np

        ms = [a.elapsed_time(b) for a, b in self.events]
        steady = ms[TRAIN_WARMUP:] or ms
        med = float(np.median(steady))
        out = dict(steps=len(ms), ms_per_step=med,
                   wall_ms_per_step=float(np.median(self.walls[TRAIN_WARMUP:] or self.walls)) * 1e3,
                   host_ms_between_steps=float(np.median(self.gaps)) * 1e3 if self.gaps else 0.0,
                   first_step_ms=ms[0], samples_per_s=samples_per_step / med * 1e3,
                   loss_first=self.losses[0], loss_last=self.losses[-1])
        if voxels_per_sample:
            out["voxels_per_s"] = samples_per_step * voxels_per_sample / med * 1e3
        return out


def _require_learning(what: str, losses):
    import numpy as np

    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{what}: non-finite training loss {losses}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise AssertionError(f"{what}: the loss did not fall over {len(losses)} steps: {losses}")


def _per_tile(model) -> dict:
    """Conv kernel launches of one U-Net forward on the engine (every
    extent even, the head fused): two SAME convs a block, one stride-2 conv
    and one transpose a level."""
    d = len(model.features)
    return {"conv3x3x3_ln_gelu": 4 * d - 2, "conv_down2x_bias": d - 1,
            "conv_transpose2x_bias": d - 1}


def _layers_alone(dev, model, params, vol, what: str) -> list:
    """Every conv layer of the engine at this input's shapes, fed the CPU
    run's input of the layer, against its plain version
    (``tools/engine_layers.py``), held to the conv kernels' tolerance."""
    from syconn_tpu_torch.models.convert import params_from_flax
    from syconn_tpu_torch.tools.engine_layers import layer_report

    rows = layer_report(model, params_from_flax(params, dev), params_from_flax(params, "cpu"),
                        vol, dev)
    for r in rows[:-1]:
        a = r["alone"]
        if a["median_rel"] >= 2e-2 or a["share_rel_gt_0.1"] >= 2e-2:
            raise AssertionError(f"{what} layer {r['layer']} {r['shape']}: kernel against its "
                                 f"plain version {a}")
    log(f"slice training layers {what}: " + json.dumps(
        [(r["layer"], r["shape"][1:4], round(r["alone"]["median_rel"], 6))
         for r in rows[:-1]]))
    return rows


def _first_tile(vol, tile, halo):
    """The dense predictor's first input window: the volume padded by the
    halo, tile + 2 x halo voxels from the origin."""
    import numpy as np

    padded = np.pad(vol, [(h, h + t) for h, t in zip(halo, tile)])
    return padded[tuple(slice(0, t + 2 * h) for t, h in zip(tile, halo))]


def _probs_budget(got, ref, what: str) -> dict:
    """uint8 probabilities of the card's engine against the plain version:
    ``ORG_BUDGET``'s shares within 2 LSB and of a stable argmax."""
    import numpy as np

    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    res = dict(within_2_lsb=float((d <= 2).mean()), max_lsb=int(d.max()),
               argmax_stable=float((got.argmax(-1) == ref.argmax(-1)).mean()))
    if (res["within_2_lsb"] < ORG_BUDGET["within_2_lsb"]
            or res["argmax_stable"] < ORG_BUDGET["argmax_stable"]):
        raise AssertionError(f"{what}: card against plain {res}, budget {ORG_BUDGET}")
    return res


def _step_card_vs_cpu(dev, what: str, build, batch, step_factory, reps: int = 5) -> dict:
    """One training step from the same seed initialisation
    (``make_train_state``) and batch on the card and on the CPU: the losses
    within ``STEP_LOSS_RTOL``; then the card's ms a step (CUDA events,
    median of ``reps`` after a warm-up) and peak bytes."""
    import numpy as np
    import torch

    from syconn_tpu_torch.models.train import make_train_state

    losses = {}
    for d in ("cpu", dev):
        state = make_train_state(build(), None, learning_rate=1e-3, seed=1, device=d)
        if d != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step_factory()(state, *batch)
        losses[str(d)] = float(m["loss"])
        if d == "cpu":
            cpu_s = time.perf_counter() - t0
    got, ref = losses[str(dev)], losses["cpu"]
    if not (np.isfinite(got) and abs(got / ref - 1) <= STEP_LOSS_RTOL):
        raise AssertionError(f"{what}: one step's loss card {got} against CPU {ref} "
                             f"(rtol {STEP_LOSS_RTOL})")
    step = step_factory()
    ms = []
    for i in range(reps + 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step(state, *batch)
        b.record()
        b.synchronize()
        if i:
            ms.append(a.elapsed_time(b))
    res = dict(loss_card=got, loss_cpu=ref, rel=abs(got / ref - 1),
               ms_per_step=float(np.median(ms)), cpu_s_per_step=cpu_s,
               samples_per_s=len(batch[0]) / float(np.median(ms)) * 1e3,
               peak_bytes=int(torch.cuda.max_memory_allocated()))
    log(f"slice training card vs cpu {what}: " + json.dumps(res))
    return res


def phase_slice_training(dev, work: str):
    """Training (``models/train.py``, ``cnn/toy.py``) on a seeded toy world
    in ``<work>/training_wd``:

    1. the organelles U-Net at its published width (``unet_variants``:
       64/128/256, patch (4, 4, 2)), ``TRAIN_STEPS`` steps of the JAX
       trainer's default tile (64, 64, 32) at batch 2 through
       ``train_toy_dense_models``: ms a step (CUDA events, median after
       ``TRAIN_WARMUP``), voxels/s, peak bytes, first and last loss (finite,
       falling); a synchronised breakdown of a step (host sampling between
       steps, forward, backward, optimizer) and the profiler's top kernels;
    2. myelin at mag 4 (64/128), ``TRAIN_STEPS`` steps, calibrated on the
       card inside the trainer (``calibrate_binary_threshold`` through the
       dense predictor on the conv kernels): threshold, seconds, launches
       (tiles x launches a tile); the engine's uint8 probabilities on the
       calibration volume against the plain version (``ORG_BUDGET``) and
       against those of the initial weights (they must differ: the trainer
       hands the calibration the trained values);
    3. one step card against CPU from the same init and batch (loss within
       ``STEP_LOSS_RTOL``) for the organelles U-Net, the celltype point net
       (published width, 2048 points, batch 8) and the view-celltype CMN
       (16/32/64, 128x64 x 2 views, batch 16), with ms a step and peak bytes;
    4. train, then deploy: ``predict_cellorganelles()`` through the
       configuration with the model just written, launches = dispatches x
       launches a tile, maps equal to a ``DenseTilePredictor`` run on the same
       weights; ``generate_subcell_kd_from_proba("mi")``; and ``start.py
       --train_models``' organelles override trained and deployed the same
       way. Every conv layer of each trained net is held to its plain
       version at the shapes its calibration or deployment gives it.

    Returns the conv kernels' launches of the calibration and deployments."""
    import numpy as np
    import torch

    from syconn_tpu_torch import global_params
    from syconn_tpu_torch.cnn import toy
    from syconn_tpu_torch.exec import exec_dense_prediction
    from syconn_tpu_torch.extraction.object_extraction import generate_subcell_kd_from_proba
    from syconn_tpu_torch.handler.config import generate_default_conf
    from syconn_tpu_torch.inference.dense import DenseTilePredictor
    from syconn_tpu_torch.io.chunked import ChunkedVolume
    from syconn_tpu_torch.models import train as mtrain
    from syconn_tpu_torch.models.cmn import MultiViewCMN
    from syconn_tpu_torch.models.io import init_model_params, load_model, load_model_meta
    from syconn_tpu_torch.models.pointnet import PointClassNet
    from syconn_tpu_torch.models.unet3d import UNet3D, unet_variants
    from syconn_tpu_torch.ops.conv3d import LAUNCHES, reset_launch_counts
    from syconn_tpu_torch.utils.testdata import generate_toy_world

    t_phase = time.perf_counter()
    wd = os.path.join(work, "training_wd")
    generate_default_conf(wd, scaling=(10, 10, 20))
    global_params.wd = wd
    cfg = global_params.config
    world = generate_toy_world(**TRAIN_WORLD)
    kd = ChunkedVolume.create(cfg.kd_seg_path, scale=(10, 10, 20), boundary=world["raw"].shape)
    kd.save_raw(world["raw"])
    kd.save_seg(world["seg"])
    launches = {k: 0 for k in REPLACES}
    out = {}

    # 1. organelles at the published width
    tile, batch = (64, 64, 32), 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _StepRecorder() as rec:
        toy.train_toy_dense_models(world, steps=TRAIN_STEPS, tile=tile, batch=batch,
                                   tasks=("organelles",), device=dev)
    res = rec.summary(batch, int(np.prod(tile)))
    res.update(seconds=time.perf_counter() - t0, peak_bytes=int(torch.cuda.max_memory_allocated()),
               host_sampling_share=sum(rec.gaps) / (time.perf_counter() - t0))
    _require_learning("organelles", rec.losses)
    if cfg.mpath_organelles != cfg.model_target("organelles"):
        raise AssertionError("the trained organelles model is not the configuration's")
    log("slice training organelles " + json.dumps(res))
    out["organelles"] = res
    model, params = load_model(cfg.mpath_organelles)
    if model.features != tuple(unet_variants("organelles")["features"]):
        raise AssertionError(f"organelles trained at {model.features}")

    # where a step's time goes: the same step, synchronised around each part
    st = mtrain.make_train_state(model, None, device=dev)
    rng = np.random.default_rng(5)
    parts = {"sample": [], "forward": [], "backward": [], "optimizer": []}
    lab = np.zeros(world["raw"].shape, np.int32)
    for c, co in enumerate(("mi", "vc", "sj"), start=1):
        lab[world[co] > 0] = c
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        offs = [[int(rng.integers(0, s - t + 1)) for s, t in zip(world["raw"].shape, tile)]
                for _ in range(batch)]
        x = np.stack([world["raw"][o[0]:o[0] + tile[0], o[1]:o[1] + tile[1],
                                   o[2]:o[2] + tile[2], None] for o in offs]).astype(np.float32)
        y = np.stack([lab[o[0]:o[0] + tile[0], o[1]:o[1] + tile[1], o[2]:o[2] + tile[2]]
                      for o in offs])
        xt = torch.from_numpy(x).to(dev)
        yt = torch.from_numpy(y).to(dev, torch.int64)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = mtrain.softmax_xent_loss(st.model(xt), yt)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        st.apply_gradients()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[k].append(v * 1e3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        loss = mtrain.softmax_xent_loss(st.model(xt), yt)
        loss.backward()
        st.apply_gradients()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0.0) > 0]
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
    top = [(e.key[:50], round(e.self_device_time_total / 1e3, 4), e.count)
           for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:8]]
    breakdown = {k: float(np.median(v[1:])) for k, v in parts.items()}
    log("slice training organelles step breakdown (synchronised ms) " + json.dumps(
        dict(breakdown, profiled_device_ms=dev_ms, top_kernels=top)))
    out["organelles"]["breakdown"] = breakdown
    del st
    model.cpu()

    # 2. myelin at mag 4, calibrated on the card inside the trainer
    cal = {}
    orig_cal = toy.calibrate_binary_threshold

    def timed_cal(m, p, raws, targets, device=None):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        thr, iou = orig_cal(m, p, raws, targets, device=device)
        torch.cuda.synchronize()
        cal.update(seconds=time.perf_counter() - t0, launches=dict(LAUNCHES), params=p,
                   raws=[np.array(r) for r in raws], threshold=thr, iou=iou)
        return thr, iou

    toy.calibrate_binary_threshold = timed_cal
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with _StepRecorder() as rec:
            toy.train_toy_dense_models(world, steps=TRAIN_STEPS, batch=batch,
                                       tasks=("myelin",), device=dev)
    finally:
        toy.calibrate_binary_threshold = orig_cal
    mag_tile = tuple(int(s) for s in np.asarray(world["raw"].shape) // 4)
    res = rec.summary(batch, int(np.prod(mag_tile)))
    res.update(seconds=time.perf_counter() - t0, peak_bytes=int(torch.cuda.max_memory_allocated()))
    _require_learning("myelin", rec.losses)
    mmodel, mparams = load_model(cfg.model_target("myelin"))
    meta = load_model_meta(cfg.model_target("myelin"))
    if meta.get("mag") != 4 or meta.get("threshold") != cal["threshold"]:
        raise AssertionError(f"myelin meta {meta} against calibration {cal['threshold']}")
    raw4 = cal["raws"][0]
    ctile = tuple(int(t) for t in np.minimum((128, 128, 64), raw4.shape))
    n_tiles = int(np.prod(-(-np.asarray(raw4.shape) // np.asarray(ctile)))) * len(cal["raws"])
    for k, per in _per_tile(mmodel).items():
        if cal["launches"][k] != n_tiles * per or per <= 0:
            raise AssertionError(f"myelin calibration: {k} launched {cal['launches'][k]} times, "
                                 f"expected {n_tiles} tiles x {per}")
        launches[k] += cal["launches"][k]
    probs = {}
    for name, p, d in (("trained", cal["params"], dev), ("plain", cal["params"], "cpu"),
                       ("initial", init_model_params(UNet3D(**unet_variants("myelin")), seed=0),
                        dev)):
        probs[name] = DenseTilePredictor(mmodel, p, tile_shape=ctile, halo=(16, 16, 8),
                                         mode="probs", device=d).predict_array(raw4)
    budget = _probs_budget(probs["trained"], probs["plain"], "myelin calibration")
    stale = float(np.mean(probs["trained"] != probs["initial"]))
    if stale < 0.5:
        raise AssertionError(f"myelin calibration: only {stale:.3f} of the probabilities differ "
                             f"from those of the initial weights")
    saved = mparams["ConvBlock_0"]["Conv_0"]["kernel"]
    if not np.array_equal(saved, cal["params"]["ConvBlock_0"]["Conv_0"]["kernel"]):
        raise AssertionError("myelin: the calibrated weights are not the saved ones")
    _layers_alone(dev, mmodel, mparams, _first_tile(raw4, ctile, (16, 16, 8)),
                  "myelin calibration tile")
    res.update(threshold=cal["threshold"], calib_iou=cal["iou"], calib_seconds=cal["seconds"],
               calib_tiles=n_tiles, calib_launches=cal["launches"], card_vs_plain=budget,
               share_differing_from_initial=stale, train_tile=list(mag_tile))
    log("slice training myelin " + json.dumps(res))
    out["myelin"] = res

    # 3. one step, card against CPU, from the same init and batch
    x = np.stack([world["raw"][o:o + 64, o:o + 64, :32, None] for o in (0, 40)]).astype(np.float32)
    y = np.stack([lab[o:o + 64, o:o + 64, :32] for o in (0, 40)])

    out["step_unet"] = _step_card_vs_cpu(dev, "organelles U-Net",
                                         lambda: UNet3D(**unet_variants("organelles")), (x, y),
                                         mtrain.make_train_step)
    prng = np.random.default_rng(7)
    pts = prng.normal(size=(POINT_STEP["batch"], POINT_STEP["npoints"], 7)).astype(np.float32)
    pts[..., 3:] = np.eye(4, dtype=np.float32)[prng.integers(0, 4, pts.shape[:2])]

    out["step_points"] = _step_card_vs_cpu(
        dev, "celltype point net", lambda: PointClassNet(n_classes=8),
        (pts, prng.integers(0, 8, POINT_STEP["batch"]).astype(np.int32)),
        lambda: mtrain.make_class_train_step(dict_output=True))
    ws = VIEW_STEP["ws"]
    views = prng.integers(0, 256, (VIEW_STEP["batch"], VIEW_STEP["nb_views"], ws[0], ws[1], 4)
                          ).astype(np.float32)

    out["step_views"] = _step_card_vs_cpu(
        dev, "view celltype CMN", lambda: MultiViewCMN(n_classes=8, widths=VIEW_STEP["widths"]),
        (views, prng.integers(0, 8, VIEW_STEP["batch"]).astype(np.int32)),
        mtrain.make_class_train_step)

    # 4. train, then deploy through the configuration
    def deploy(what):
        omodel, oparams = load_model(cfg.mpath_organelles)
        torch.cuda.synchronize()
        reset_launch_counts()
        st = exec_dense_prediction.predict_cellorganelles(mag=1, device=dev, show_progress=False)
        got = dict(LAUNCHES)
        for k, per in _per_tile(omodel).items():
            if got[k] <= 0 or got[k] != st["dispatches"] * per:
                raise AssertionError(f"{what} deployment: {k} launched {got[k]} times, "
                                     f"expected {st['dispatches']} dispatches x {per}")
            launches[k] += got[k]
        ts, halo = exec_dense_prediction._tile_params(cfg.kd_seg_path, 1)
        ref = DenseTilePredictor(omodel, oparams, tile_shape=ts, halo=halo, mode="probs",
                                 device=dev).predict_array(world["raw"])
        for co, ch in (("mi", 1), ("vc", 2), ("sj", 3)):
            m = ChunkedVolume.open(getattr(cfg, f"kd_{co}_path")).load_raw(
                size=world["raw"].shape)
            if not np.array_equal(m, ref[..., ch]):
                raise AssertionError(f"{what} deployment: the {co} map differs from the "
                                     f"dense predictor's on the same weights")
        ex = generate_subcell_kd_from_proba("mi", device=dev)
        _layers_alone(dev, omodel, oparams, _first_tile(world["raw"], ts, halo),
                      f"{what} deployment tile")
        r = dict(dispatches=st["dispatches"], seconds=st["seconds"], tile=list(ts),
                 halo=list(halo), launches=got, mi_objects=ex.get("n_objects"))
        log(f"slice training deploy {what} " + json.dumps(r))
        return r

    out["deploy"] = deploy("organelles")
    t0 = time.perf_counter()
    with _StepRecorder() as rec:
        toy.train_toy_dense_models(world, steps=5, tile=tile, batch=batch, tasks=("organelles",),
                                   variant_overrides={"organelles": START_OVERRIDE}, device=dev)
    out["deploy_start_override"] = deploy("start.py override")
    out["deploy_start_override"]["train_seconds"] = time.perf_counter() - t0
    global_params.wd = None
    log(f"slice training phase {time.perf_counter() - t_phase:.3f} s")
    return launches, out


DRIVER_A = ["--shape", "512", "512", "256", "--n_cells", "16", "--seed", "0",
            "--predict_organelles", "--overwrite"]
DRIVER_GEN_CHECK = dict(shape=(128, 128, 64), n_cells=6, seed=4)
DRIVER_CS_WINDOWS = 4
QUALITY = dict(seed=777, shape=(160, 160, 80), n_cells=8)
SCORE_GROUPS = ("synapses", "celltype", "celltype_views", "compartments", "spinehead", "myelin")


def _check_driver_outputs(wd: str, what: str) -> dict:
    """Every cell of a driver run has its cell type, embedding and skeleton
    axoness and myelin; ``syn_ssv`` is not empty, and the matrix has one row
    for each synapse whose ``syn_prob`` reaches ``thresh_synssv_proba``."""
    import numpy as np

    from syconn_tpu_torch import global_params
    from syconn_tpu_torch.reps.segmentation import SegmentationDataset
    from syconn_tpu_torch.reps.super_segmentation import SuperSegmentationDataset

    global_params.wd = wd
    ssd = SuperSegmentationDataset(working_dir=wd)
    if len(ssd.ssv_ids) == 0:
        raise AssertionError(f"driver {what}: no cells")
    for i in ssd.ssv_ids:
        ssv = ssd.get_super_segmentation_object(int(i))
        ssv.load_attr_dict()
        missing = [k for k in ("celltype_cnn_e3", "latent_morph") if k not in ssv.attr_dict]
        if missing or not ssv.load_skeleton() or any(
                k not in ssv.skeleton for k in ("axoness", "myelin")):
            raise AssertionError(f"driver {what}: cell {int(i)} lacks {missing} or its "
                                 "skeleton's axoness/myelin")
    sd = SegmentationDataset("syn_ssv", working_dir=wd)
    prob = np.asarray(sd.load_numpy_data("syn_prob"))
    thr = float(global_params.config["cell_objects"]["thresh_synssv_proba"])
    with open(os.path.join(wd, "connectivity_matrix", "conn_mat.csv")) as f:
        rows = len(f.read().splitlines()) - 1
    if len(sd.ids) == 0 or rows != int(np.sum(prob >= thr)):
        raise AssertionError(f"driver {what}: {len(sd.ids)} syn_ssv, {rows} matrix rows for "
                             f"{int(np.sum(prob >= thr))} with syn_prob >= {thr}")
    return dict(cells=int(len(ssd.ssv_ids)), syn_ssv=int(len(sd.ids)), matrix_rows=rows)


def _check_driver_contacts(dev, what: str, chunk) -> dict:
    """Step 6 of a driver run on its own windows: every chunk of the
    resident segmentation through ``ResidentCsDetector`` on the card (the
    hand-written kernel, tables built on the card, overflowing columns
    patched) equals the exact host kernel on the same window, and on the
    ``DRIVER_CS_WINDOWS`` most label-rich windows ``detect_cs_columns_device``
    on the card equals its plain version on the CPU (partners and overflow
    flags). Exact: every value is a label."""
    import numpy as np
    import torch

    from syconn_tpu_torch import global_params
    from syconn_tpu_torch.io import resident
    from syconn_tpu_torch.ops.contacts import detect_cs
    from syconn_tpu_torch.ops.contacts_cuda import detect_cs_columns
    from syconn_tpu_torch.ops.contacts_torch import (ResidentCsDetector, column_tables,
                                                     detect_cs_columns_device)

    cfg = global_params.config
    stencil = tuple(int(s) for s in cfg["cell_objects"]["cs_filtersize"])
    seg = resident.get(cfg.kd_seg_path, "seg", 1)
    if seg is None or seg.device.type != "cuda":
        raise AssertionError(f"driver {what}: the segmentation is not resident on the card")
    t0 = time.perf_counter()
    det = ResidentCsDetector(seg, chunk=tuple(int(c) for c in chunk), stencil=stencil)
    if det.kernel != "cuda":
        raise AssertionError(f"driver {what}: the resident detector took {det.kernel}")
    cixs = [(x, y, z) for x in range(det.grid[0]) for y in range(det.grid[1])
            for z in range(det.grid[2])]
    n_labels, n_contacts = [], 0
    for cix in cixs:
        win = det.window(cix)
        packed, _ = det.fetch(det.dispatch(cix))
        host = detect_cs(win.cpu().numpy().astype(np.uint32), stencil=stencil)
        host = host[:packed.shape[0], :packed.shape[1], :packed.shape[2]]
        if not np.array_equal(packed, host):
            raise AssertionError(f"driver {what}: chunk {cix} on the card differs from the host "
                                 f"kernel on {int((packed != host).sum())} voxels")
        n_contacts += int((packed != 0).sum())
        n_labels.append(int(torch.unique(win).numel()))
    if n_contacts == 0:
        raise AssertionError(f"driver {what}: no contact voxel in any chunk")
    rich = sorted(range(len(cixs)), key=lambda i: -n_labels[i])[:DRIVER_CS_WINDOWS]
    for i in rich:
        win = det.window(cixs[i])
        p_c, o_c = detect_cs_columns_device(win, stencil)
        p_p, o_p = detect_cs_columns_device(win.cpu(), stencil)
        if not (torch.equal(p_c.cpu(), p_p) and torch.equal(o_c.cpu(), o_p)):
            raise AssertionError(f"driver {what}: detect_cs_columns_device on the card differs "
                                 f"from the plain version on window {cixs[i]}")
    # the kernel alone on the most label-rich window
    args = column_tables(det.window(cixs[rich[0]]), stencil)[:3]
    live = float((args[2] != np.iinfo(np.int32).max).sum(dim=1).float().mean())
    k_ms = cuda_ms(lambda: detect_cs_columns(*args, stencil, (32, 32)))
    return dict(chunks=len(cixs), equal_host_kernel=len(cixs), equal_plain_windows=len(rich),
                labels_per_window=[min(n_labels), max(n_labels)], contact_voxels=n_contacts,
                overflow_columns=det.n_overflow, columns=det.n_columns,
                richest_window=dict(chunk=cixs[rich[0]], live_candidates_per_column=live,
                                    kernel_ms=k_ms),
                seconds=time.perf_counter() - t0)


def phase_slice_driver(dev, work: str) -> dict:
    """The pipeline driver on the card, as a user runs it: the device world
    generator card against CPU on ``DRIVER_GEN_CHECK`` (seg, mi, vc, sj
    equal), then ``examples.start.main`` for run A (``DRIVER_A``: the
    512x512x256 Voronoi world from the device generator, organelles
    predicted) and run B (the quality fixture ``QUALITY``, then its scores;
    no score is gated: the JAX package's own quality gates are red). Per
    run: the launches of the organelles and myelin U-Nets' convs equal
    dispatches x ``PER_TILE``, those of the contact kernel the chunks of
    ``--chunk_size``; ``timing.json``'s seconds per step and per gigavoxel;
    the outputs of ``_check_driver_outputs``. Returns the launches."""
    import numpy as np
    import torch

    from syconn_tpu_torch import global_params
    from syconn_tpu_torch.examples import start
    from syconn_tpu_torch.io import resident
    from syconn_tpu_torch.ops.conv3d import LAUNCHES, reset_launch_counts
    from syconn_tpu_torch.utils.quality_metrics import quality_pipeline_argv, score_all
    from syconn_tpu_torch.utils.testdata import generate_toy_world

    t0 = time.perf_counter()
    card = generate_toy_world(**DRIVER_GEN_CHECK, device=dev)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = generate_toy_world(**DRIVER_GEN_CHECK, device="cpu")
    t_cpu = time.perf_counter() - t0
    differ = {k: int(np.sum(card[k] != host[k])) for k in ("seg", "mi", "vc", "sj")}
    log("slice driver generator " + json.dumps(dict(DRIVER_GEN_CHECK, card_s=t_card,
                                                    cpu_s=t_cpu, voxels_apart=differ)))
    if any(differ.values()):
        raise AssertionError(f"device world generator: card and CPU differ {differ}")
    del card, host

    launches = {k: 0 for k in LAUNCHES}
    runs = {"A": ["--working_dir", os.path.join(work, "driver_A"), *DRIVER_A],
            "B": quality_pipeline_argv(os.path.join(work, "driver_B"), QUALITY["seed"],
                                       QUALITY["shape"], QUALITY["n_cells"])}
    runs = {k: v + ["--device", str(dev)] for k, v in runs.items()}
    for what, argv in runs.items():
        args = start.parse_args(argv)
        wd = args.working_dir
        torch.cuda.synchronize()
        reset_launch_counts()
        stats = {}
        t0 = time.perf_counter()
        start.main(argv, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        for k in REPLACES:
            want = sum(stats[t]["dispatches"] * PER_TILE[t][k] for t in ("organelles", "myelin"))
            if want <= 0 or counts[k] != want:
                raise AssertionError(f"driver {what}: {k} launched {counts[k]} times, expected "
                                     f"{want} (organelles and myelin dispatches x per tile)")
        chunks = int(np.prod(-(-np.asarray(args.shape) // np.asarray(args.chunk_size))))
        syn = stats["syn"]["stats"]
        if not (counts["detect_cs_columns"] == syn["dispatched"] == chunks) or \
                syn["path"] != "resident" or syn["host_chunks"] != 0:
            raise AssertionError(f"driver {what}: contact kernel launched "
                                 f"{counts['detect_cs_columns']} times, {syn['dispatched']} "
                                 f"chunks dispatched of {chunks} on the {syn['path']} route, "
                                 f"{syn['host_chunks']} on the host")
        if what == "A" and stats["world"]["route"] != "device":
            raise AssertionError(f"driver A: the world came from the {stats['world']['route']}")
        for k, n in counts.items():
            launches[k] += n
        with open(os.path.join(wd, "timing.json")) as f:
            timing = json.load(f)
        outputs = _check_driver_outputs(wd, what)
        cs_check = _check_driver_contacts(dev, what, args.chunk_size)
        log(f"slice driver {what} contacts " + json.dumps(cs_check))
        log(f"slice driver {what} " + json.dumps(dict(
            shape=args.shape, wall_s=wall, world=stats["world"], gvx=timing["gvx"],
            steps_s=timing["steps_s"],
            s_per_gvx={k: v / timing["gvx"] for k, v in timing["steps_s"].items()},
            organelles=dict(route=stats["organelles"]["route"],
                            dispatches=stats["organelles"]["dispatches"]),
            myelin=dict(route=stats["myelin"]["route"], dispatches=stats["myelin"]["dispatches"]),
            contacts=dict(path=syn["path"], dispatched=syn["dispatched"],
                          host_chunks=syn["host_chunks"], columns=syn["columns"],
                          overflow_columns=syn["overflow_columns"]),
            n_syn_ssv=stats["syn"]["n_syn_ssv"], launches=counts, **outputs)))
        # where the steps' seconds go: step 2's organelle extraction, scan
        # and analysis, step 6's stages and its contact detection
        sds = stats["sds"]["stats"]
        log(f"slice driver {what} stages " + json.dumps(dict(
            extraction={co: dict(route=e["route"], n_objects=e["n_objects"], seconds=e["seconds"])
                        for co, e in sds["extraction"].items() if e},
            scan={k: v for k, v in sds["scan"].items()
                  if k.endswith("seconds") or k == "cell_route"},
            dataset_analysis_s=sds["dataset_analysis_seconds"], syn_stages_s=stats["syn"]["stages"],
            contacts_s={k: syn[k] for k in ("seconds", "detect_seconds", "post_seconds",
                                            "write_seconds")})))
    scores = score_all(start.parse_args(runs["B"]).working_dir, device=dev)
    for group in SCORE_GROUPS:
        log(f"slice driver B score {group} " + json.dumps(scores.get(group)))
        if not isinstance(scores.get(group), dict):
            raise AssertionError(f"quality fixture: no {group} scores")
    resident.clear()
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
        train_launches, _ = phase_slice_training(dev, work)
        for k in REPLACES:
            launches[k] += train_launches[k]
        t_pipe = time.perf_counter()
        pipe_launches = phase_slice_pipeline(dev, work)
        for k in REPLACES:
            launches[k] += pipe_launches[k]
        contacts["launches"] += pipe_launches["detect_cs_columns"]
        log(f"slice pipeline phase {time.perf_counter() - t_pipe:.3f} s")
        t_cells = time.perf_counter()
        points = phase_points(dev)
        log(f"points phase {time.perf_counter() - t_cells:.3f} s")
        t_views = time.perf_counter()
        view_ms, frame_ms = phase_views(dev)
        log(f"views phase {time.perf_counter() - t_views:.3f} s")
        t_cells = time.perf_counter()
        cells_launches = phase_slice_cells(dev, work, points["glia_pts"]["forward_ms"])
        for k in REPLACES:
            launches[k] += cells_launches[k]
        log(f"slice cells phase {time.perf_counter() - t_cells:.3f} s")
        t_syn = time.perf_counter()
        syn_launches = phase_slice_synapses(dev, work)
        for k in REPLACES:
            launches[k] += syn_launches[k]
        contacts["launches"] += syn_launches["detect_cs_columns"]
        log(f"slice synapses phase {time.perf_counter() - t_syn:.3f} s")
        t_morph = time.perf_counter()
        phase_slice_morphology(dev, work, {t: r["forward_ms"] for t, r in points.items()})
        log(f"slice morphology phase {time.perf_counter() - t_morph:.3f} s")
        t_views = time.perf_counter()
        phase_slice_views(dev, work, view_ms, frame_ms)
        log(f"slice views phase {time.perf_counter() - t_views:.3f} s")
        t_driver = time.perf_counter()
        driver_launches = phase_slice_driver(dev, work)
        for k in REPLACES:
            launches[k] += driver_launches[k]
        contacts["launches"] += driver_launches["detect_cs_columns"]
        log(f"slice driver phase {time.perf_counter() - t_driver:.3f} s")
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
