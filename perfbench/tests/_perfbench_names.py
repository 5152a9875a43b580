"""The names that ``BENCHMARK.json`` gives, read when the tests are
collected, so that a cell or configuration added later is tested without an
edit to any test file."""

import json
import os

from perfbench.lib.harness import DEFAULT_FAMILY

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)

CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]


def _config(entry):
    with open(os.path.join(ROOT, entry["file"])) as f:
        return json.load(f)


# each configuration's file and model family
CONFIG = {c["name"]: _config(c) for c in BENCH["configs"]}
FAMILY = {n: cfg.get("family", DEFAULT_FAMILY) for n, cfg in CONFIG.items()}
UNET3D_CONFIGS = [n for n in CONFIGS if FAMILY[n] == "unet3d"]
UNET3D_CELLS = [w["name"] for w in BENCH["workloads"] if FAMILY[w["config"]] == "unet3d"]
