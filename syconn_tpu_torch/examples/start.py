"""Full-pipeline example driver (counterpart of
``syconn_tpu/examples/start.py``).

Runs every stage on a synthetic EM cube generated on the fly: dense
predictions -> object extraction -> cell assembly -> skeletons -> synapses
-> compartments -> embeddings -> celltype -> connectivity-matrix export.
Timings are recorded per step (``FileTimer``, ``.timing.pkl`` and
``timing.json``) under the JAX driver's names.

Usage::

    python -m syconn_tpu_torch.examples.start --shape 256 256 128 --n_cells 6 --overwrite
    python -m syconn_tpu_torch.examples.start ... --device cpu   # without a card

Every flag of the JAX driver is kept, with its default and behaviour.
``--device`` (the card unless ``cpu``) replaces the JAX driver's link
probe and is resolved before anything is written. ``--shard_pipeline`` /
``--no-shard_pipeline`` write ``tpu.shard_pipeline`` into the config: the
hot steps split over every attached card where several are (default on),
and run serially on one card, as the JAX driver does on one device.
``--run_server`` serves the
finished working directory with ``analysis/server.py`` on port 10001 once
``timing.json`` is written, until interrupted. Departures from the JAX
driver: trained models go to ``<wd>/models/`` (``DynConfig.model_target``),
never over the packaged weights; ``timing.json`` keeps the step seconds of
an earlier run only when that run had the same shape, cell count and world.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import shutil
import sys
import time

import numpy as np

__all__ = ["main", "parse_args"]


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX driver's arguments and ``--device``."""
    parser = argparse.ArgumentParser(description="syconn_tpu_torch example run")
    parser.add_argument("--working_dir", type=str, default="")
    parser.add_argument("--shape", type=int, nargs=3, default=[256, 256, 128],
                        help="synthetic cube shape (x y z)")
    parser.add_argument("--n_cells", type=int, default=6)
    parser.add_argument("--log_level", type=str, default="INFO")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--prior_astrocyte_removal", action="store_true")
    parser.add_argument("--run_server", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--chunk_size", type=int, nargs=3, default=[128, 128, 64],
                        help="extraction/skeleton chunk shape; larger chunks "
                             "amortize per-chunk host work at GVx scale")
    parser.add_argument("--train_models", action="store_true",
                        help="train the dense models on the toy ground truth "
                             "before running inference (train->deploy loop)")
    parser.add_argument("--train_steps", type=int, default=800)
    parser.add_argument("--use_views", action="store_true",
                        help="use the multi-view (rendered 2D projections) "
                             "models instead of point-cloud models for "
                             "compartments/celltype/embeddings")
    parser.add_argument("--organelles", type=str, default="mi,vc",
                        help="comma-separated cell organelles to process "
                             "(subset of mi,vc,er,golgi; sj is always used "
                             "for synapses)")
    parser.add_argument("--world", type=str, default="voronoi",
                        choices=("voronoi", "neuron"),
                        help="synthetic world flavor: 'voronoi' (dense cell "
                             "packing, throughput benchmarks) or 'neuron' "
                             "(tubular morphology with celltype/compartment/"
                             "spine/myelin ground truth for quality checks)")
    parser.add_argument("--predict_organelles", action="store_true",
                        help="produce the mi/vc/sj probability maps by dense "
                             "model inference on the raw volume (packaged or "
                             "working-dir weights) instead of copying the "
                             "generator's ground-truth maps")
    parser.add_argument("--kv", type=str, action="append", default=[],
                        help="extra config override 'section.key=value' "
                             "(repeatable; value parsed as YAML). E.g. "
                             "physical parameters that must follow the "
                             "dataset's scale: --kv compartments."
                             "dist_axoness_averaging=500 on a toy-extent "
                             "world (reference default 10000 nm assumes "
                             "mm-scale neurites)")
    parser.add_argument("--until_step", type=int, default=99,
                        help="stop after this pipeline step (0 = data "
                             "preparation only, 6 = synapse detection). "
                             "Training-world generation for the point "
                             "models only needs geometry + syn_ssv, not "
                             "the inference steps 7-9")
    parser.add_argument("--shard_pipeline", action=argparse.BooleanOptionalAction,
                        default=None,
                        help="run the hot pipeline steps sharded over ALL "
                             "attached cards (object extraction, contact "
                             "detection and property scans over an 'sp' mesh "
                             "axis with halos copied between cards; dense and "
                             "point inference batch-split over 'data'). "
                             "Default: on whenever >1 card is attached; "
                             "--no-shard_pipeline forces serial")
    parser.add_argument("--device", type=str, default=None,
                        help="cpu, or the CUDA card (default; required then)")
    return parser.parse_args(argv)


def _write_timing_json(wd, args, ftimer):
    """Per-step seconds as JSON next to the pickle. A rerun of a prepared
    working directory (``--until_step 0``, then a run without
    ``--overwrite``) merges into the existing file, so that the prep run's
    'Preparation' survives; a file from a run of another shape, cell count
    or world is replaced, not merged into."""
    path = os.path.join(wd, "timing.json")
    head = {"shape": list(args.shape), "n_cells": args.n_cells, "world": args.world}
    steps = {}
    if os.path.isfile(path):
        try:
            with open(path) as f:
                prev = json.load(f)
        except (OSError, ValueError):
            prev = {}
        if all(prev.get(k) == v for k, v in head.items()):
            steps = prev.get("steps_s", {})
    steps.update({k: round(float(v), 2) for k, v in ftimer.timings.items()})
    with open(path, "w") as f:
        json.dump({**head, "gvx": float(np.prod(args.shape)) / 1e9, "steps_s": steps},
                  f, indent=1)


def _reset_process_state(wd: str) -> None:
    """Point the process-wide state at ``wd``: the working directory and a
    fresh config, no cached chunk stores, decompressed chunks or resident
    volumes of an earlier run, and no log file of an earlier working
    directory on the driver's logger."""
    from .. import global_params
    from ..handler.basics import clear_kd_cache
    from ..io import resident
    from ..io.chunked import clear_chunk_cache

    clear_kd_cache()
    clear_chunk_cache()
    resident.clear()
    global_params.wd = wd
    global_params.config = None
    global_params._init_config()
    lg = logging.getLogger("example_run")
    for h in [h for h in lg.handlers if isinstance(h, logging.FileHandler)]:
        lg.removeHandler(h)
        h.close()


def _neuron_gt(wd: str, world: dict) -> None:
    """The construction ground truth of a neuron world, for quality scoring."""
    sv_ids = np.asarray(sorted(world["sv2cell"]), np.uint64)
    syn = world["syn_gt"]
    np.savez_compressed(
        os.path.join(wd, "neuron_gt.npz"),
        celltype_gt=world["celltype_gt"],
        compart=world["compart"],
        spiness=world["spiness"],
        myelin=world["myelin"],
        sv_ids=sv_ids,
        sv_cells=np.asarray([world["sv2cell"][int(s)] for s in sv_ids], np.int64),
        syn_coords=np.asarray([s["coord_vx"] for s in syn], np.float64).reshape(-1, 3),
        syn_pre=np.asarray([s["pre_cell"] for s in syn], np.int64),
        syn_post=np.asarray([s["post_cell"] for s in syn], np.int64),
        syn_sign=np.asarray([1 if s["sign"] == "asym" else -1 for s in syn], np.int8),
        syn_on_spine=np.asarray([s["on_spine"] for s in syn], bool),
        syn_head_vol=np.asarray([s["head_vol_vx"] for s in syn], np.float64),
    )


def main(argv=None, stats=None) -> None:
    """Run the pipeline as ``argv`` (default ``sys.argv[1:]``) says.
    ``stats`` (optional dict) receives the world generator's route and
    seconds and the statistics the steps return (``"organelles"``,
    ``"myelin"``, ``"sds"``, ``"syn"``)."""
    args = parse_args(argv)
    from ..utils.device import default_device

    dev = default_device(args.device)
    stats = {} if stats is None else stats

    organelles = [o.strip() for o in args.organelles.split(",") if o.strip()]
    if not set(organelles) <= {"mi", "vc", "er", "golgi"}:
        raise ValueError(f"--organelles: {organelles} is not a subset of mi,vc,er,golgi")

    from .. import global_params
    from ..handler import yamlio
    from ..handler.config import generate_default_conf, initialize_logging
    from ..io import resident
    from ..io.chunked import ChunkedVolume
    from ..io.graph import save_svgraph
    from ..proc.stats import FileTimer
    from ..utils.testdata import auto_world_device, generate_toy_world

    wd = args.working_dir or os.path.expanduser("~/syconn_tpu_example/")
    scale = np.array([10, 10, 20])
    chunk_size = tuple(int(c) for c in args.chunk_size)
    neuron = args.world == "neuron"

    generate_default_conf(
        wd,
        scale,
        key_value_pairs=[
            ("glia", {"prior_astrocyte_removal": args.prior_astrocyte_removal}),
            ("use_point_models", not args.use_views),
            ("syntype_avail", True),
            ("min_cc_size_ssv", 500),
            ("log_level", 20 if args.log_level == "INFO" else 10),
            ("process_cell_organelles", organelles),
            ("cell_objects", {
                # the neuron world builds organelles at sizes that follow its
                # tube calibers (~30-80 voxels), far below the Voronoi world's
                # blobs: the thresholds follow, or every mi/vc is filtered
                "extract_morph_op": {"mi": ["binary_closing"], "vc": ["binary_closing"],
                                     "sj": [], "er": ["binary_closing"],
                                     "golgi": ["binary_closing"]},
                "min_obj_vx": ({"mi": 20, "vc": 10, "sj": 10, "er": 20, "golgi": 20,
                                "sv": 1, "cs": 10, "syn": 10, "syn_ssv": 20}
                               if neuron else
                               {"mi": 200, "vc": 100, "sj": 30, "er": 100, "golgi": 100,
                                "sv": 1, "cs": 10, "syn": 10, "syn_ssv": 20}),
                "sizethresholds": ({"mi": 20, "vc": 10, "sj": 10, "er": 20, "golgi": 20}
                                   if neuron else
                                   {"mi": 200, "vc": 100, "sj": 30, "er": 100, "golgi": 100}),
            }),
            ("skeleton", {"kimimaro_skelgen": {"dust_threshold": 200},
                          "kimimaro_merge": {"dust_threshold": 150, "tick_threshold": 300}}),
        ] + ([("tpu", {"shard_pipeline": bool(args.shard_pipeline)})]
             if args.shard_pipeline is not None else []),
        force_overwrite=True,
    )
    _reset_process_state(wd)
    log = initialize_logging("example_run", log_dir=wd + "/logs/")
    cfg = global_params.config

    if args.kv:
        # sections replace the defaults wholesale when read back, so merge
        # each override into the effective section before writing
        for kv in args.kv:
            path, _, raw = kv.partition("=")
            keys = path.strip().split(".")
            val = yamlio.load(raw)  # as yaml.safe_load reads it
            if len(keys) == 1:
                cfg[keys[0]] = val
            else:
                section = copy.deepcopy(cfg[keys[0]])
                node = section
                for k in keys[1:-1]:
                    node = node.setdefault(k, {})
                node[keys[-1]] = val
                cfg[keys[0]] = section
        cfg.write_config()

    ftimer = FileTimer(wd + "/.timing.pkl", overwrite=True)
    ftimer.dataset_shape = list(args.shape)
    ftimer.dataset_scale = scale.tolist()
    on_card = dev.type == "cuda"
    # the world's dense fields on the run's card for large volumes
    world_device = auto_world_device(args.shape, dev if on_card else None)

    def put(path, channel, arr) -> bool:
        # the resident store holds volumes in the card's memory; a CPU run
        # reads its volumes from disk, as the JAX package does on the CPU
        return on_card and resident.put(path, channel, arr, device=dev)

    def make_world():
        t0 = time.perf_counter()
        if neuron:
            from ..utils.testdata_neuro import generate_neuron_world

            w = generate_neuron_world(shape=tuple(args.shape), n_cells=args.n_cells,
                                      seed=args.seed)
        else:
            w = generate_toy_world(shape=tuple(args.shape), n_cells=args.n_cells,
                                   seed=args.seed, device=world_device or False)
        stats["world"] = {"route": "device" if w.get("_device") else "host",
                          "seconds": time.perf_counter() - t0}
        return w

    # ------------------------------------------------------------ toy data
    log.info("Step 0/9 - Preparation (synthetic EM world %s)", args.shape)
    ftimer.start("Preparation")
    world = None
    if args.overwrite or not os.path.isdir(cfg.kd_seg_path):
        world = make_world()
        kd = ChunkedVolume.create(cfg.kd_seg_path, scale=scale, boundary=world["seg"].shape,
                                  chunk_shape=chunk_size)
        kd.save_raw(world["raw"], mags=[1, 2, 4])
        kd.save_seg(world["seg"], mags=[1, 2])
        # register the working set on the card: dense prediction, object
        # extraction and contact detection then slice from device memory
        # (disk stays the durability layer); the device generator's fields
        # are handed over as the tensors they are
        dev_fields = world.get("_device") or {}
        put(cfg.kd_seg_path, "raw", world["raw"])
        put(cfg.kd_seg_path, "seg", dev_fields.get("seg", world["seg"]))
        predicted_cos = {"mi", "vc", "sj"} if args.predict_organelles else set()
        for co in organelles + ["sj", "sym", "asym"]:
            if co in predicted_cos:
                continue
            cv = ChunkedVolume.create(getattr(cfg, f"kd_{co}_path"), scale=scale,
                                      boundary=world["seg"].shape, chunk_shape=chunk_size)
            cv.save_raw(world[co], mags=[1, 2])
            if co in organelles or co == "sj":
                put(getattr(cfg, f"kd_{co}_path"), "raw", dev_fields.get(co, world[co]))
        save_svgraph(world["rag"], cfg.init_svgraph_path)
        if neuron:
            _neuron_gt(wd, world)
    elif on_card:
        # reused working directory: hydrate the resident store from disk once
        kd = ChunkedVolume.open(cfg.kd_seg_path)
        put(cfg.kd_seg_path, "raw", kd.load_raw())
        seg_host = kd.load_seg()
        if seg_host.max(initial=0) < 2**31:
            put(cfg.kd_seg_path, "seg", seg_host)
        del seg_host
        for co in organelles + ["sj"]:
            p = getattr(cfg, f"kd_{co}_path")
            if os.path.isdir(p):
                put(p, "raw", ChunkedVolume.open(p).load_raw())
    from ..exec import exec_dense_prediction

    if args.predict_organelles:
        log.info("Predicting mi/vc/sj probability maps from raw (dense model)")
        stats["organelles"] = exec_dense_prediction.predict_cellorganelles(mag=1, device=dev)
    ftimer.stop()

    if args.train_models:
        log.info("Step 0.5/9 - Training dense models on the toy ground truth")
        ftimer.start("Model training")
        if world is None:
            world = generate_toy_world(shape=tuple(args.shape), n_cells=args.n_cells,
                                       seed=args.seed, device=world_device or False)
        from ..cnn.toy import train_toy_dense_models

        # the nets go to <wd>/models/ (cfg.model_target), which the mpath_*
        # of this working directory name from then on
        accs = train_toy_dense_models(
            world, steps=args.train_steps, log_cb=log.info,
            tasks=("organelles", "myelin"),
            # finer patch resolves the small toy organelles
            variant_overrides={"organelles": dict(features=(32, 64), strides=((2, 2, 2),),
                                                  patch=(2, 2, 2))},
            device=dev,
        )
        log.info("trained toy models: %s", accs)
        # trained organelle predictions now replace the generated prob maps
        for co in ["mi", "vc", "sj"]:
            p = getattr(cfg, f"kd_{co}_path")
            if os.path.isdir(p):
                shutil.rmtree(p)
        stats["organelles"] = exec_dense_prediction.predict_cellorganelles(mag=1, device=dev)
        ftimer.stop()

    if args.until_step < 1:
        # data preparation only: a later run WITHOUT --overwrite re-hydrates
        # the resident store from the chunk store and continues from step 1
        log.info("until_step < 1: stopping after Preparation")
        _write_timing_json(wd, args, ftimer)
        return

    from ..exec import exec_inference, exec_init, exec_skeleton, exec_syns

    log.info("Step 1/9 - Predicting sub-cellular structures")
    ftimer.start("Dense predictions")
    stats["myelin"] = exec_dense_prediction.predict_myelin(device=dev)  # mag from the model meta
    ftimer.stop()

    log.info("Step 2/9 - Creating SegmentationDatasets (incl. SV meshes)")
    ftimer.start("SD generation")
    stats["sds"] = exec_init.init_cell_subcell_sds(chunk_size=chunk_size,
                                                   overwrite=args.overwrite, device=dev)
    exec_init.run_create_rag()
    ftimer.stop()

    log.info("Step 3/9 - Astrocyte separation")
    if cfg.prior_astrocyte_removal:
        ftimer.start("Astrocyte separation")
        exec_inference.run_astrocyte_prediction_pts(device=dev)
        exec_inference.run_astrocyte_splitting(device=dev)
        ftimer.stop()
    else:
        log.info("Astrocyte separation disabled. Skipping.")

    log.info("Step 4/9 - Creating SuperSegmentationDataset")
    ftimer.start("SSD generation")
    exec_init.run_create_neuron_ssd(overwrite=args.overwrite, device=dev)
    ftimer.stop()

    log.info("Step 5/9 - Skeleton generation")
    ftimer.start("Skeleton generation")
    exec_skeleton.run_skeleton_generation(map_myelin=True, cube_size=chunk_size, device=dev)
    ftimer.stop()

    log.info("Step 6/9 - Synapse detection")
    ftimer.start("Synapse detection")
    stats["syn"] = exec_syns.run_syn_generation(chunk_size=chunk_size, overwrite=args.overwrite,
                                                device=dev)
    ftimer.stop()

    log.info("Step 6.5/9 - Contact detection")
    ftimer.start("Contact detection")
    if cfg["cell_contacts"]["generate_cs_ssv"]:
        exec_syns.run_cs_ssv_generation(overwrite=args.overwrite, device=dev)
    ftimer.stop()

    if args.until_step >= 7:
        log.info("Step 7/9 - Compartment prediction")
        ftimer.start("Compartment predictions")
        exec_inference.run_semsegaxoness_prediction(device=dev)
        exec_inference.run_semsegspiness_prediction(device=dev)
        exec_syns.run_spinehead_volume_calc(device=dev)
        ftimer.stop()

    if args.until_step >= 8:
        log.info("Step 8/9 - Cell-morphology embeddings")
        ftimer.start("Morphology extraction")
        exec_inference.run_morphology_embedding(device=dev)
        ftimer.stop()

    if args.until_step >= 9:
        log.info("Step 9/9 - Celltype analysis")
        ftimer.start("Celltype analysis")
        exec_inference.run_celltype_prediction(device=dev)
        ftimer.stop()

        log.info("Step - Matrix export")
        ftimer.start("Matrix export")
        exec_syns.run_matrix_export(device=dev)
        ftimer.stop()

    log.info("\n" + ftimer.prepare_report())
    _write_timing_json(wd, args, ftimer)
    if args.run_server:
        from ..analysis.server import main as server_main

        sys.argv = ["syconn.server", f"--working_dir={wd}", "--port=10001"]
        server_main()


if __name__ == "__main__":
    main()
