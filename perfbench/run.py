"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``; ``limits`` last); the last lines of
standard error give each number compared with its limit. Exits non-zero,
printing no result, without as many CUDA cards as the cell asks for, or when
the run's process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(ROOT, ".perfbench_cache")
    for var, sub in (("SYCONN_TORCH_BUILD_DIR", "torch_build"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(cache, sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from perfbench.lib import harness

    chips = harness.Cell(ROOT, args.workload).chips
    _cache_dirs()
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s), found {have}; "
              "no CPU fallback", file=sys.stderr)
        return 2
    result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                         t_start=T_START, log=lambda m: None)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, line in result["limits"].items():
        print(f"check {name}: {line['value']} (limit {line['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
