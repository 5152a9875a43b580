"""The profiler's device trace over one stretch of whole passes, and the
arithmetic every trace reader shares: device activity per card, its union,
idle gaps and the time of named kernels.

The stretch is marked by two annotations recorded on the host's monotonic
clock as well, so that host spans can be placed on the trace's time line.
After the end mark each card gets two CUDA events some 100 ms of spinning
apart, each followed by a short marker kernel: the time between the first
and the last marker kernel in the trace, over the events' elapsed time, tells
whether the trace kept the card's clock. A trace whose ratio is off (every
device operation read at about half its time, once in eight traced runs of
one cell) is not complete, and its device times are not read.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
START, END = "perfbench_stretch_start", "perfbench_stretch_end"
# the kernel of ``torch.cuda._sleep``, which the program never launches
MARKER = "spin_kernel"
MARKER_CYCLES = 1000
# the spin between the two events, some 100 ms on an H100: over 20 ms the
# trace read 0.3-2.7% short of the events in sound stretches
CLOCK_CYCLES = 200_000_000
# how far the trace's time between the marker kernels may lie from the
# events' elapsed time, as a share of it
CLOCK_TOLERANCE = 0.05


class Profile:
    """``torch.profiler`` over CPU and CUDA activity with the stretch's
    marks; :meth:`mark` is called once at each end of the stretch, and after
    the end mark puts the clock's events and marker kernels on each of
    ``cards``. (A marker kernel enqueued at the stretch's start was missing
    from every trace of a device cell's 40 s window, 27 stretches of 27 on an
    H100, though from none of 9 others; those after the end never were.)"""

    def __init__(self, out_path: str, cards: Sequence[int] = ()):
        import torch

        self.torch = torch
        self.out_path = out_path
        self.cards = list(cards)
        self.marks: Dict[str, int] = {}
        self._events: Dict[int, Tuple[object, object]] = {}
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
        if name == END:
            self._mark_clock()

    def _mark_clock(self) -> None:
        """Outside the stretch, so that no metric sees the spin."""
        cuda = self.torch.cuda
        for d in self.cards:
            with cuda.device(d):
                a, b = cuda.Event(enable_timing=True), cuda.Event(enable_timing=True)
                a.record()
                cuda._sleep(MARKER_CYCLES)
                cuda._sleep(CLOCK_CYCLES)
                b.record()
                cuda._sleep(MARKER_CYCLES)
            self._events[d] = (a, b)
        for d in self.cards:
            cuda.synchronize(d)     # every marker kernel ends inside the session

    def device_elapsed(self) -> Dict[int, float]:
        """Seconds between the clock's two events on each card."""
        return {d: a.elapsed_time(b) / 1e3 for d, (a, b) in self._events.items()}

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.prof.export_chrome_trace(self.out_path)
        return False


class Trace:
    """Device events inside the stretch, in microseconds of the trace's
    clock, and the map from host nanoseconds onto it."""

    def __init__(self, events: List[Dict], start: float, end: float,
                 host_anchor_ns: Optional[int] = None,
                 clock_ratio: Optional[Dict[int, Optional[float]]] = None):
        self.events = events
        self.start, self.end = start, end
        self._anchor = host_anchor_ns
        self.clock_ratio = dict(clock_ratio or {})

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def complete(self) -> bool:
        """Whether every marked card's trace kept the card's clock (a trace
        without device marks is taken as it is)."""
        return all(r is not None and abs(r - 1.0) <= CLOCK_TOLERANCE
                   for r in self.clock_ratio.values())

    def host_us(self, ns: int) -> float:
        return (ns - self._anchor) / 1e3 + self.start


def load(path: str, marks: Dict[str, int],
         elapsed: Optional[Dict[int, float]] = None) -> Trace:
    """The stretch's device events from the chrome trace at ``path``, which
    is removed. ``elapsed`` (seconds between the clock's events, by card)
    gives each card's clock ratio from its three marker kernels, which are
    left out of the events."""
    with open(path) as f:
        raw = json.load(f)
    evs = raw["traceEvents"] if isinstance(raw, dict) else raw
    ann = {e["name"]: float(e["ts"]) for e in evs
           if e.get("name") in (START, END) and e.get("ph") == "X"}
    if START not in ann or END not in ann:
        raise RuntimeError("the trace lacks the stretch's marks")
    out, markers = [], {}
    for e in evs:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        dev = e.get("args", {}).get("device")
        if dev is None:
            continue
        if e["cat"] == "kernel" and MARKER in e["name"]:
            markers.setdefault(int(dev), []).append(float(e["ts"]))
            continue
        out.append(dict(name=e["name"], cat=e["cat"], ts=float(e["ts"]),
                        dur=float(e.get("dur", 0.0)), device=int(dev)))
    ratio = {}
    for d, s in (elapsed or {}).items():
        ts = sorted(markers.get(d, []))
        ratio[d] = (ts[-1] - ts[0]) / 1e6 / s if len(ts) == 3 and s > 0 else None
    t = Trace(clip(out, ann[START], ann[END]), ann[START], ann[END], marks.get(START), ratio)
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
