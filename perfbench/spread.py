"""Run one cell several times, each run its own process, and report the
spread of each metric.

    python3 perfbench/spread.py --workload <name> --seconds <s> --seeds 1 2 3 ...
        [--trace 0|1] [--out <file.jsonl>]

Runs ``perfbench/run.py`` once per seed, one after another, appends each
result line (or the run's exit code and the end of its standard error) to
``--out``, and prints per metric the median and the spread: the distance
between the first and third quartiles (``statistics.quantiles(n=4)``) as a
share of the median.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rows = []
    for seed in args.seeds:
        t0, started = time.perf_counter(), time.time()
        p = subprocess.run([sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
                            "--workload", args.workload, "--seed", str(seed),
                            "--seconds", str(args.seconds), "--trace", str(args.trace)],
                           cwd=ROOT, capture_output=True, text=True)
        row = {"workload": args.workload, "seed": seed, "trace": args.trace, "rc": p.returncode,
               "started": started, "wall_s": time.perf_counter() - t0}
        lines = p.stdout.strip().splitlines()
        if p.returncode == 0 and lines:
            row["result"] = json.loads(lines[-1])
        else:
            row["stderr"] = p.stderr[-4000:]
        rows.append(row)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        res = row.get("result", {})
        print(json.dumps({"seed": seed, "rc": p.returncode, "wall_s": round(row["wall_s"], 1),
                          "correct": res.get("correct"),
                          "metrics": {k: v["value"] for k, v in res.get("metrics", {}).items()},
                          "limits": res.get("limits")}), flush=True)
        if "stderr" in row:
            print(row["stderr"][-2000:], flush=True)
    names = sorted({k for r in rows for k in r.get("result", {}).get("metrics", {})})
    for name in names:
        vals = [r["result"]["metrics"][name]["value"] for r in rows
                if name in r.get("result", {}).get("metrics", {})]
        print(json.dumps({"metric": name, "n": len(vals), "median": statistics.median(vals),
                          "spread": spread(vals), "values": vals}), flush=True)
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
