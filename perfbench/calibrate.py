"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 perfbench/calibrate.py --workload <name> --seeds 1 2 ... [--control 1 2 3]

In one process, for every seed: the cell's inputs, one pass of its route
(the window's own call at the cell's size) and the judge's numbers, the
program against the reference (the lower readings); then, for every
``--control`` seed, the same with the reference in float8 put in the
program's place (the upper readings). Prints one JSON line per reading and
a summary line: the largest program reading and the smallest control
reading of every number.
"""

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reading(cell, seed: int, control: bool, device: str) -> dict:
    import torch

    from perfbench.lib import harness

    if device == "cuda":
        devices = [torch.device("cuda", i) for i in range(cell.chips)]
    else:
        devices = [torch.device("cpu")] * cell.chips
    work = os.path.join(ROOT, ".perfbench_run", "calibrate")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        ctx = harness.Ctx(cell, seed, 0.0, False, devices, work)
        ctx.params = ctx.family.make_params(ctx.arch, seed, ctx.device)
        state = cell.route.setup(ctx)
        t0 = time.perf_counter()
        cell.route.run_pass(ctx, state, 1)
        t_pass = time.perf_counter() - t0
        t0 = time.perf_counter()
        judged = cell.route.judge(ctx, state, control=control)
        return dict(seed=seed, control=control, numbers=judged["numbers"],
                    missing=judged["missing"], pass_s=t_pass,
                    judge_s=time.perf_counter() - t0)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.environ["SYCONN_TORCH_BUILD_DIR"] = os.path.join(ROOT, ".perfbench_cache", "torch_build")
    from perfbench.lib import harness

    cell = harness.Cell(ROOT, args.workload)
    rows = []
    for seed in args.seeds:
        rows.append(reading(cell, seed, False, args.device))
        print(json.dumps(rows[-1]), flush=True)
    for seed in args.control:
        rows.append(reading(cell, seed, True, args.device))
        print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for name in cell.limits:
        prog = [r["numbers"].get(name) for r in rows if not r["control"]]
        ctrl = [r["numbers"].get(name) for r in rows if r["control"]]
        summary[name] = {"lower": max((v for v in prog if v is not None), default=None),
                         "upper": min((v for v in ctrl if v is not None), default=None),
                         "program": prog, "control": ctrl}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
