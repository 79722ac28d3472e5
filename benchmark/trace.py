"""The traced run: ``torch.profiler`` (CPU and CUDA activity) over a run of
whole units inside the window, reduced in memory to what the per-layer
metrics read.  No trace is written to disk.

From the profiler's raw events (``kineto_results.events()``):

- device operations: every event on the device (kernels, copies, sets)
  but the device mirrors of ``record_function`` ranges, each with its
  start, duration and, through its correlation id, the host time at which
  it was launched;
- host spans: the harness's ``record_function`` ranges (``bench.*``) and
  every other host event, for naming what the host did while the device
  sat idle;
- busy time: the union of the device operations' intervals; the traced
  window is the host's clock between the two device synchronisations that
  bound the traced units.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from benchmark import common

HARNESS_PREFIX = "bench."
RUNTIME_PREFIXES = ("cuda", "cuLaunch", "cuMem")


@dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    launch_ns: Optional[int]


@dataclass
class Trace:
    ops: List[DeviceOp]
    spans: List[Tuple[str, int, int]]           # harness spans (name, start, end), ns
    host: List[Tuple[str, int, int]]            # other host events
    window_s: float
    units: int
    launch_found: int = 0

    @property
    def busy_s(self) -> float:
        return union_ns([(o.start_ns, o.start_ns + o.dur_ns) for o in self.ops]) / 1e9

    def device_s(self, pred=lambda op: True) -> float:
        return sum(o.dur_ns for o in self.ops if pred(o)) / 1e9


def union_ns(intervals) -> int:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Tracer:
    """Starts the profiler at the window's first unit boundary and stops it
    ``units`` units later, each edge after a device synchronisation."""

    def __init__(self, units: int, device):
        self.units = units
        self.device = device
        self.prof = None
        self.t0 = self.window_s = None
        self.first = None
        self.trace: Optional[Trace] = None

    def boundary(self, n: int) -> bool:
        """True while the traced units are still running."""
        if self.trace is not None or self.window_s is not None:
            return False
        if self.prof is None:
            common.sync(self.device)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.first = n
            self.t0 = time.perf_counter()
            return True
        if n - self.first < self.units:
            return True
        common.sync(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        return False

    def result(self) -> Optional[Trace]:
        if self.window_s is None:
            return None
        if self.trace is None:
            self.trace = reduce(self.prof, self.window_s, self.units)
            self.prof = None
        return self.trace


def _is_device(e) -> bool:
    return e.device_type() != torch.autograd.DeviceType.CPU


def reduce(prof, window_s: float, units: int) -> Trace:
    events = prof.profiler.kineto_results.events()
    runtime, by_op = {}, {}     # CUDA API calls by CUPTI id; host ops by their own id
    spans, host = [], []
    for e in events:
        if _is_device(e):
            continue
        name, a, d = e.name(), e.start_ns(), e.duration_ns()
        if name.startswith(HARNESS_PREFIX):
            spans.append((name, a, a + d))
            continue
        host.append((name, a, a + d))
        (runtime if name.startswith(RUNTIME_PREFIXES) else by_op)[e.correlation_id()] = a
    ops, found = [], 0
    for e in events:
        if not _is_device(e) or e.is_user_annotation() or e.name().startswith(HARNESS_PREFIX):
            continue
        launch = runtime.get(e.correlation_id())
        if launch is None:
            launch = by_op.get(e.linked_correlation_id())
        found += launch is not None
        ops.append(DeviceOp(e.name(), e.start_ns(), e.duration_ns(), launch))
    return Trace(ops=ops, spans=spans, host=host, window_s=window_s, units=units,
                 launch_found=found)


def top_ops(tr: Trace, n: int = 10) -> list:
    by = {}
    for o in tr.ops:
        by[o.name] = by.get(o.name, 0) + o.dur_ns
    return [[name[:160], ns / 1e9] for name, ns in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(tr: Trace, n: int = 10) -> list:
    """The ``n`` longest gaps between device operations, each named by the
    harness span and the innermost host event open at its middle."""
    iv = sorted((o.start_ns, o.start_ns + o.dur_ns) for o in tr.ops)
    gaps, end = [], None
    for a, b in iv:
        if end is not None and a > end:
            gaps.append((a - end, end, a))
        end = b if end is None else max(end, b)
    out = []
    for length, a, b in sorted(gaps, reverse=True)[:n]:
        mid = (a + b) // 2
        span = next((s for s, x, y in tr.spans if x <= mid <= y), "outside network calls")
        inner = [(y - x, name) for name, x, y in tr.host if x <= mid <= y]
        what = min(inner)[1] if inner else "no host event"
        out.append([f"{span}: {what}"[:160], length / 1e9])
    return out
