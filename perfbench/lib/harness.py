"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result line.

Everything that belongs to one configuration, traffic mix, route, cell or
per-layer metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives:

* ``perfbench/configs/<config>.json`` (the entry's ``file``),
* ``perfbench/families/<family>.py`` (the configuration's ``family``,
  ``unet3d`` where it names none: ``make_params``, ``program_model``,
  ``reference_forward``, ``flops``, ``conv_launches``, ``CONV_KERNELS``),
* ``perfbench/traffic/<traffic>.json`` (names its ``route``),
* ``perfbench/routes/<route>.py`` (``SPANS``, ``setup``, ``run_pass``,
  ``judge``),
* ``perfbench/limits/<workload>.json`` (the limits of ``correct``),
* ``perfbench/metrics/<metric>.py`` (``read(ctx)``, None when it finds
  nothing to read).
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)

# the model family of a configuration that names none
DEFAULT_FAMILY = "unet3d"

# top-level module names that must not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "syconn_tpu")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _safe(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


class Cell:
    """A cell of ``BENCHMARK.json`` with its files resolved by name."""

    def __init__(self, root: str, workload: str, overrides: Optional[Dict] = None):
        self.root = root
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = cells[workload]
        self.name = workload
        cfg_entry = {c["name"]: c for c in self.bench["configs"]}[self.entry["config"]]
        self.config = load_json(os.path.join(root, cfg_entry["file"]))
        self.traffic = load_json(os.path.join(BENCH_DIR, "traffic", self.entry["traffic"] + ".json"))
        self.limits = load_json(os.path.join(BENCH_DIR, "limits", workload + ".json"))
        ov = overrides or {}
        self.config = dict(self.config, **ov.get("config", {}))
        self.traffic = dict(self.traffic, **ov.get("traffic", {}))
        self.route = load_module(os.path.join(BENCH_DIR, "routes", self.traffic["route"] + ".py"),
                                 "perfbench_route_" + _safe(self.traffic["route"]))
        family = self.config.get("family", DEFAULT_FAMILY)
        path = os.path.join(BENCH_DIR, "families", family + ".py")
        if not os.path.isfile(path):
            raise ValueError(f"configuration {self.entry['config']!r} names the model family "
                             f"{family!r}, whose file {os.path.relpath(path, root)} does not exist")
        self.family = load_module(path, "perfbench_family_" + _safe(family))
        self.chips = int(ov.get("chips", self.entry["chips"]))
        # a rate that no end-to-end entry lists for the cell would be left
        # out of its result line, and the run would report set-up alone
        if self.rate_metric not in {m["name"] for m in self.end_to_end()}:
            raise ValueError(f"cell {workload!r} computes the rate {self.rate_metric!r}, which no "
                             "end_to_end entry of BENCHMARK.json lists for it: add the cell to "
                             "that metric's workloads")

    @property
    def arch(self) -> Dict:
        return self.config["arch"]

    @property
    def rate_metric(self) -> str:
        """The cell's rate: the traffic's ``rate_metric``, with ``{config}``
        replaced by the cell's configuration."""
        return self.traffic["rate_metric"].format(config=self.entry["config"])

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> List[Dict]:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def reader(self, metric: str):
        return load_module(os.path.join(BENCH_DIR, "metrics", metric + ".py"),
                           "perfbench_metric_" + _safe(metric))


class Ctx:
    """What a route and a metric reader see of the run."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, devices, work: str):
        self.cell = cell
        self.config, self.traffic, self.arch = cell.config, cell.traffic, cell.arch
        self.family = cell.family
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.devices = list(devices)
        self.device = self.devices[0]
        self.work = work
        self.params = None          # the family's weights on the device (the reference reads these)
        self.spans = None
        # filled in as the run goes
        self.trace_data = None
        self.stretch_spans: List[Dict] = []
        self.stretch_passes = 0
        self.first_traced: Optional[int] = None
        self.traced_passes: List[int] = []      # of every stretch traced, kept or not
        self.trace_clock: List[Dict] = []       # each traced stretch's clock ratio by card
        self.window_passes = 0
        self.window_seconds = 0.0
        self.pass_seconds: List[float] = []

    def reference(self, window, precision: str = "f32"):
        """The family's plain forward of one input window with the run's
        weights: uint8 probabilities (C, X, Y, Z)."""
        return self.family.reference_forward(self.arch, self.params, window, precision)

    @property
    def n_cards(self) -> int:
        return len(self.devices)

    @property
    def card_indices(self) -> List[int]:
        return sorted({d.index or 0 for d in self.devices})

    @property
    def tile(self):
        return [int(t) for t in self.config["tile"]]

    @property
    def halo(self):
        return [int(h) for h in self.config["halo"]]

    @property
    def window_shape(self):
        return [t + 2 * h for t, h in zip(self.tile, self.halo)]

    @property
    def volume(self):
        return [int(v) for v in self.traffic["volume"]]

    @property
    def tiles_per_pass(self) -> int:
        n = 1
        for s, t in zip(self.volume, self.tile):
            n *= -(-s // t)
        return n

    @property
    def voxels_per_pass(self) -> int:
        v = self.volume
        return v[0] * v[1] * v[2]

    @property
    def mapping(self) -> Dict[str, int]:
        return {k: int(v) for k, v in self.config["mapping"].items()}


# stretches traced at most in one run: one whose trace did not keep the
# card's clock is traced again from the next pass
TRACE_ATTEMPTS = 3


def load_stretch(prof):
    """The stretch's device trace, with each card's clock ratio; None
    without a card (a CPU run has no device trace to read)."""
    from . import trace as tr

    if not prof.cards:
        return None
    return tr.load(prof.out_path, prof.marks, prof.device_elapsed())


def _sync(ctx: Ctx) -> None:
    import torch

    if ctx.device.type == "cuda":
        for d in ctx.card_indices:
            torch.cuda.synchronize(d)


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run(root: str, workload: str, seed: int, seconds: float, trace: bool,
        t_start: Optional[float] = None, device: str = "cuda",
        overrides: Optional[Dict] = None, log=None) -> Dict:
    """One run of ``workload``; returns the result line as a dict (with
    ``correct``, ``metrics``, ``device``, ``limits`` ...). ``device="cpu"``
    (tests only) runs the program's plain versions on a logical mesh of CPU
    devices."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from . import trace as tr
    from .spans import Spans

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = Cell(root, workload, overrides)
    if device == "cuda":
        devices = [torch.device("cuda", i) for i in range(cell.chips)]
    else:
        devices = [torch.device("cpu")] * cell.chips
    work = os.path.join(root, ".perfbench_run", workload)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ctx = Ctx(cell, seed, seconds, trace, devices, work)
    route = cell.route
    try:
        ctx.params = ctx.family.make_params(ctx.arch, seed, ctx.device)
        state = route.setup(ctx)
        if trace:
            ctx.spans = Spans()
            for target, name, attrs in route.SPANS:
                ctx.spans.install(target, name, attrs)
        route.run_pass(ctx, state, 0)             # warm-up: every shape of the window
        if trace and ctx.device.type == "cuda":
            with tr.Profile(os.path.join(work, "warm.json")):
                torch.ones(8, device=ctx.device).sum()   # CUPTI's start-up, out of the window
            os.remove(os.path.join(work, "warm.json"))
        _sync(ctx)
        setup_s = time.perf_counter() - t_start
        if ctx.device.type == "cuda":
            for d in ctx.card_indices:
                torch.cuda.reset_peak_memory_stats(d)

        stretch = int(ctx.traffic.get("trace_passes", 1)) if trace else 0
        cards = ctx.card_indices if ctx.device.type == "cuda" else []
        first_traced = None
        prof = None
        passes = 0
        pass_s = []
        t0 = time.perf_counter()
        t_last = t0
        while True:
            elapsed = t_last - t0
            if stretch and first_traced is None and elapsed >= 0.4 * seconds:
                first_traced = passes
                prof = tr.Profile(os.path.join(work, "trace.json"), cards).__enter__()
                ctx.spans.clear()
                prof.mark(tr.START)
            route.run_pass(ctx, state, passes + 1)
            passes += 1
            if prof is not None and passes == first_traced + stretch:
                prof.mark(tr.END)
                snapshot = ctx.spans.snapshot()
                prof.__exit__(None, None, None)
                ctx.traced_passes += list(range(first_traced, passes))
                data = load_stretch(prof)
                prof = None
                ctx.trace_clock.append(data.clock_ratio if data is not None else {})
                if data is None or data.complete or len(ctx.trace_clock) == TRACE_ATTEMPTS:
                    ctx.stretch_spans = snapshot
                    ctx.stretch_passes = stretch
                    ctx.first_traced = first_traced
                    ctx.trace_data = data
                else:
                    print(f"perfbench: the trace of passes {first_traced + 1}-{passes} did not "
                          f"keep the card's clock ({data.clock_ratio}); tracing again",
                          file=sys.stderr, flush=True)
                    first_traced = None
            pass_s.append(time.perf_counter() - t_last)
            t_last = time.perf_counter()
            if t_last - t0 >= seconds and (not stretch or ctx.stretch_passes):
                break
        ctx.window_passes = passes
        ctx.window_seconds = t_last - t0
        ctx.pass_seconds = pass_s
        peak = 0
        if ctx.device.type == "cuda":
            peak = max(torch.cuda.max_memory_allocated(d) for d in ctx.card_indices)
        if ctx.spans is not None:
            ctx.spans.uninstall()

        judged = route.judge(ctx, state)
        del state
        return _result(ctx, cell, judged, setup_s, peak, log)
    finally:
        if ctx.spans is not None:
            ctx.spans.uninstall()
        shutil.rmtree(work, ignore_errors=True)


def _result(ctx: Ctx, cell: Cell, judged: Dict, setup_s: float, peak: int, log) -> Dict:
    import torch

    from . import judge as jd
    from . import trace as tr

    v = jd.verdict(judged["numbers"], cell.limits, judged["missing"], judged["tile_max"])
    rate = ctx.window_passes * ctx.voxels_per_pass / ctx.window_seconds / 1e6
    units = {m["name"]: m["unit"] for m in cell.bench["end_to_end"] + cell.bench["per_layer"]}
    metrics: Dict[str, Dict] = {}
    if not ctx.trace:
        values = {"setup_s": setup_s, cell.rate_metric: rate}
        for m in cell.end_to_end():
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}
    else:
        for m in cell.per_layer():
            val = cell.reader(m["name"]).read(ctx)
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": units[m["name"]]}
    if ctx.device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": ctx.n_cards,
               "memory_peak_bytes": int(peak), "power_limit": _power_limit()}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": ctx.n_cards, "memory_peak_bytes": 0}
    out = {"correct": bool(v["correct"]),
           "attempted": ctx.window_passes * ctx.tiles_per_pass,
           "failed": int(v["failed"]),
           "metrics": metrics, "device": dev}
    if ctx.trace:
        judged.setdefault("notes", {})["trace_clock"] = ctx.trace_clock
    if ctx.trace and ctx.trace_data is not None:
        t = ctx.trace_data
        dev["busy_s"] = tr.busy_s(t, ctx.card_indices)
        dev["window_s"] = t.seconds
        out["breakdown"] = {"device_ops": tr.top_ops(t),
                            "idle_gaps": tr.labelled_gaps(t, ctx.card_indices, ctx.stretch_spans)}
        if ctx.n_cards > 1:
            judged.setdefault("notes", {})["per_card"] = {
                str(d): {"idle_share": tr.idle_share(t, [d]),
                         "idle_gaps": tr.labelled_gaps(t, [d], ctx.stretch_spans, n=5)}
                for d in ctx.card_indices}
    out["window"] = {"passes": ctx.window_passes, "seconds": ctx.window_seconds,
                     "pass_seconds": ctx.pass_seconds,
                     "tiles_compared": v["compared"], "missing": v["missing"],
                     **judged.get("notes", {})}
    out["limits"] = v["lines"]
    for name, line in v["lines"].items():
        log(f"check {name}: {line['value']} (limit {line['limit']})")
    return out
