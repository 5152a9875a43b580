"""The profiler's device trace over one stretch of whole passes, and the
arithmetic every trace reader shares: device activity per card, its union,
idle gaps and the time of named kernels.

The stretch is marked by two annotations recorded on the host's monotonic
clock as well, so that host spans can be placed on the trace's time line.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
START, END = "perfbench_stretch_start", "perfbench_stretch_end"


class Profile:
    """``torch.profiler`` over CPU and CUDA activity with the stretch's
    marks; :meth:`mark` is called once at each end of the stretch."""

    def __init__(self, out_path: str):
        import torch

        self.torch = torch
        self.out_path = out_path
        self.marks: Dict[str, int] = {}
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def mark(self, name: str) -> None:
        with self.torch.profiler.record_function(name):
            self.marks[name] = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.prof.export_chrome_trace(self.out_path)
        return False


class Trace:
    """Device events inside the stretch, in microseconds of the trace's
    clock, and the map from host nanoseconds onto it."""

    def __init__(self, events: List[Dict], start: float, end: float,
                 host_anchor_ns: Optional[int] = None):
        self.events = events
        self.start, self.end = start, end
        self._anchor = host_anchor_ns

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e6

    def host_us(self, ns: int) -> float:
        return (ns - self._anchor) / 1e3 + self.start


def load(path: str, marks: Dict[str, int]) -> Trace:
    with open(path) as f:
        raw = json.load(f)
    evs = raw["traceEvents"] if isinstance(raw, dict) else raw
    ann = {e["name"]: float(e["ts"]) for e in evs
           if e.get("name") in (START, END) and e.get("ph") == "X"}
    if START not in ann or END not in ann:
        raise RuntimeError("the trace lacks the stretch's marks")
    out = []
    for e in evs:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        dev = e.get("args", {}).get("device")
        if dev is None:
            continue
        out.append(dict(name=e["name"], cat=e["cat"], ts=float(e["ts"]),
                        dur=float(e.get("dur", 0.0)), device=int(dev)))
    t = Trace(clip(out, ann[START], ann[END]), ann[START], ann[END], marks.get(START))
    os.remove(path)
    return t


def clip(events: Iterable[Dict], start: float, end: float) -> List[Dict]:
    """Events cut to [start, end]; those wholly outside dropped."""
    out = []
    for e in events:
        a, b = max(e["ts"], start), min(e["ts"] + e["dur"], end)
        if b > a:
            out.append(dict(e, ts=a, dur=b - a))
    return out


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_intervals(trace: Trace, device: int) -> List[Tuple[float, float]]:
    return union((e["ts"], e["ts"] + e["dur"]) for e in trace.events if e["device"] == device)


def busy_s(trace: Trace, devices: Sequence[int]) -> float:
    """Seconds in which some operation ran, averaged over ``devices``."""
    tot = 0.0
    for d in devices:
        tot += sum(b - a for a, b in busy_intervals(trace, d))
    return tot / 1e6 / max(1, len(devices))


def idle_share(trace: Trace, devices: Sequence[int]) -> Optional[float]:
    """1 - busy / stretch, in %, averaged over ``devices``."""
    if trace.seconds <= 0:
        return None
    return 100.0 * (1.0 - busy_s(trace, devices) / trace.seconds)


def gaps(trace: Trace, device: int) -> List[Tuple[float, float]]:
    """Idle intervals of one card inside the stretch."""
    out, t = [], trace.start
    for a, b in busy_intervals(trace, device):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if trace.end > t:
        out.append((t, trace.end))
    return out


def matching(trace: Trace, names: Sequence[str]) -> List[Dict]:
    return [e for e in trace.events if e["cat"] == "kernel" and any(n in e["name"] for n in names)]


def top_ops(trace: Trace, n: int = 10) -> List[List]:
    """The device operations that took most time, summed by name."""
    tot: Dict[str, float] = {}
    for e in trace.events:
        tot[e["name"]] = tot.get(e["name"], 0.0) + e["dur"] / 1e6
    return [[k[:120], v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def labelled_gaps(trace: Trace, devices: Sequence[int], spans: List[Dict],
                  n: int = 10) -> List[List]:
    """The longest idle gaps over ``devices``, each named by the host spans
    open at its midpoint (``host`` where none was)."""
    placed = [(trace.host_us(s["t0"]), trace.host_us(s["t1"]), s["name"]) for s in spans]
    out = []
    for d in devices:
        for a, b in gaps(trace, d):
            mid = 0.5 * (a + b)
            names = sorted({nm for s0, s1, nm in placed if s0 <= mid <= s1})
            label = "+".join(names) if names else "host"
            if len(devices) > 1:
                label = f"card{d}:{label}"
            out.append([label[:120], (b - a) / 1e6])
    return sorted(out, key=lambda x: -x[1])[:n]
