"""The names that ``BENCHMARK.json`` gives, read when the tests are
collected, so that a cell or configuration added later is tested without an
edit to any test file."""

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)

CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]
