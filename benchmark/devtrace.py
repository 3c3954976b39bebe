"""The device's side of a traced window, from torch.profiler.

The profiler records the window (CPU and CUDA activity). Its events are
read once it has stopped: each kernel, copy and memset on the card with
its start and end, moved onto the host clock by a marker that opens the
window (`benchmark.window`), whose host-clock start the harness read as
it entered it.
"""

from __future__ import annotations

import contextlib
import time

MARKER = "benchmark.window"


class DeviceTrace:
    """Device operations of one window: (name, t0, t1) on the host
    clock, in seconds."""

    def __init__(self, ops: list, t0: float, t1: float):
        self.t0, self.t1 = t0, t1
        self.ops = sorted(ops, key=lambda o: o[1])

    @staticmethod
    def kind(name: str) -> str:
        if name.startswith("Memcpy"):
            return "copy"
        if name.startswith("Memset"):
            return "memset"
        return "kernel"

    def seconds(self, kind: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.ops if self.kind(n) == kind)

    def busy(self) -> list:
        """The union of the operations' intervals, inside the window."""
        out: list = []
        for _, a, b in self.ops:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def idle_gaps(self) -> list:
        gaps, at = [], self.t0
        for a, b in self.busy():
            if a > at:
                gaps.append((at, a))
            at = b
        if self.t1 > at:
            gaps.append((at, self.t1))
        return gaps

    def top_ops(self, n: int = 10) -> list:
        by: dict = {}
        for name, t0, t1 in self.ops:
            by[name] = by.get(name, 0.0) + (t1 - t0)
        return sorted(([k[:96], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


def host_segments(calls: list, t0: float, t1: float) -> list:
    """The host's timeline of the window as (start, end, label), in
    order and without overlap: each stage the program timed, a call
    outside its stages, or the harness between calls."""
    out, at = [], t0
    for c in calls:
        if c.t0 > at:
            out.append((at, c.t0, "between calls"))
        at = max(at, c.t0)
        for name, s0, s1 in sorted(c.spans, key=lambda s: s[1]):
            if s0 > at:
                out.append((at, s0, "call, outside the stages"))
            if s1 > max(at, s0):
                out.append((max(at, s0), s1, name))
            at = max(at, s1)
        if c.t1 > at:
            out.append((at, c.t1, "call, outside the stages"))
        at = max(at, c.t1)
    if t1 > at:
        out.append((at, t1, "between calls"))
    return out


def idle_by_host(trace: DeviceTrace, calls: list, n: int = 10) -> list:
    """The device's idle time, summed by what the host was doing
    meanwhile (host_segments), largest first."""
    by: dict = {}
    segs = host_segments(calls, trace.t0, trace.t1)
    i = 0
    for a, b in trace.idle_gaps():
        while i < len(segs) and segs[i][1] <= a:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < b:
            s0, s1, label = segs[j]
            by[label] = by.get(label, 0.0) + min(b, s1) - max(a, s0)
            j += 1
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


class Profiler:
    """torch.profiler over a window: start() in set-up, window() around
    the measured calls, then trace() once the profiler has stopped."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        import torch
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._mark_ns = None

    def start(self) -> None:
        self._prof.__enter__()

    @contextlib.contextmanager
    def window(self):
        from torch.profiler import record_function
        self._mark_ns = time.perf_counter_ns()
        with record_function(MARKER):
            yield

    def stop(self) -> None:
        self._prof.__exit__(None, None, None)

    def trace(self, t0: float, t1: float) -> DeviceTrace:
        """The device operations of the window [t0, t1] (host clock)."""
        events = self._prof.profiler.kineto_results.events()
        mark = next(e for e in events if e.name() == MARKER
                    and e.device_type().name == "CPU")
        shift = mark.start_ns() - self._mark_ns
        ops = []
        for e in events:
            # kernels, copies and memsets; not the annotations (the
            # marker's own row on the device) or the synchronizations
            # that some versions record on the device's rows
            if (e.device_type().name != "CUDA" or e.name() == MARKER
                    or e.is_user_annotation() or "Sync" in e.name()):
                continue
            s = (e.start_ns() - shift) * 1e-9
            ops.append((e.name(), s, s + e.duration_ns() * 1e-9))
        return DeviceTrace(ops, t0, t1)
