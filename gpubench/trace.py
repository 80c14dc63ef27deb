"""The device trace of a traced run: ``torch.profiler`` around the traced
steps, read back from its Chrome trace (written under ``TMPDIR``, read
and deleted at once) into plain lists that the metric readers take:

    ops      device operations (kernels, copies, sets): name, start, end
             in microseconds, and the host ranges they were launched under
    host     the host's ops and ranges on each thread: name, start, end
    wall_s   the traced window on the host's clock

Busy time is the union of the device operations' intervals (an NCCL
kernel counts as busy); idle gaps are the holes in it, each named by the
innermost host op that was running at the gap's middle.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Op:
    name: str
    start: float
    end: float
    ranges: Tuple[str, ...] = ()

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclass
class Trace:
    ops: List[Op]
    host: Dict[int, List[Op]]
    wall_s: float
    steps: int
    counters: Dict[str, float] = field(default_factory=dict)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((o.start, o.end) for o in self.ops)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_span_s(self) -> float:
        """From the first device operation's start to the last one's end."""
        if not self.ops:
            return 0.0
        return (max(o.end for o in self.ops)
                - min(o.start for o in self.ops)) / 1e6

    def time_under(self, *names: str) -> float:
        """Device seconds of the operations launched under any host range
        in `names`."""
        return sum(o.dur for o in self.ops
                   if any(n in o.ranges for n in names)) / 1e6

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """The `n` longest holes between busy intervals: (what the host
        was doing at the hole's middle, seconds), longest first."""
        busy = self.busy_intervals()
        gaps = sorted(((s1 - e0, (e0 + s1) / 2)
                       for (_, e0), (s1, _) in zip(busy, busy[1:])
                       if s1 > e0), reverse=True)[:n]
        return [(self._host_at(mid), length / 1e6) for length, mid in gaps]

    def _host_at(self, t: float) -> str:
        best = None
        for ops in self.host.values():
            for o in ops:
                if o.start <= t <= o.end and (best is None or o.dur < best.dur):
                    best = o
        return best.name if best is not None else "host: python"

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        tot: Dict[str, float] = {}
        for o in self.ops:
            tot[o.name] = tot.get(o.name, 0.0) + o.dur / 1e6
        return sorted(tot.items(), key=lambda kv: -kv[1])[:n]


def capture(fn: Callable[[], int], sync: Callable[[], None]) -> Trace:
    """Run `fn` (which returns how many steps it ran) under the profiler
    and read its trace."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = fn()
        sync()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="gpubench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return parse(events, wall, steps)


def parse(events: List[Dict], wall_s: float, steps: int) -> Trace:
    """A :class:`Trace` from Chrome-trace events (complete events, "X")."""
    host: Dict[int, List[Op]] = {}
    launches: Dict[int, Tuple[int, float]] = {}
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append(ev)
        elif cat in HOST_CATS:
            host.setdefault(ev.get("tid"), []).append(
                Op(ev["name"], ts, ts + dur))
        elif cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ev.get("tid"), ts)
    for ops in host.values():
        ops.sort(key=lambda o: o.start)
    by_thread: Dict[int, List[Tuple[float, int]]] = {}
    for j, ev in enumerate(device):
        corr = ev.get("args", {}).get("correlation")
        if corr in launches:
            tid, t = launches[corr]
            by_thread.setdefault(tid, []).append((t, j))
    ranges: Dict[int, Tuple[str, ...]] = {}
    for tid, points in by_thread.items():
        ranges.update(_enclosing(host.get(tid, []), sorted(points)))
    ops = [Op(ev["name"], float(ev["ts"]),
              float(ev["ts"]) + float(ev.get("dur", 0.0)),
              ranges.get(j, ())) for j, ev in enumerate(device)]
    return Trace(ops=ops, host=host, wall_s=wall_s, steps=steps)


def _enclosing(ops: List[Op], points: List[Tuple[float, int]]
               ) -> Dict[int, Tuple[str, ...]]:
    """For each (time, key) in `points` (sorted by time), the names of the
    ops of one thread (nested intervals, sorted by start) open at that
    time, outermost first."""
    out: Dict[int, Tuple[str, ...]] = {}
    stack: List[Op] = []
    i = 0
    for t, key in points:
        while i < len(ops) and ops[i].start <= t:
            while stack and stack[-1].end < ops[i].start:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out[key] = tuple(o.name for o in stack if o.end >= t)
    return out
