"""Stage timing + throughput metrics (SURVEY §5.1/§5.5 obligations).

The reference has only a dead *stats* table and commented format traces
(deflate.lisp:74,91). Here: a lightweight stage timer that aggregates
bytes/second per pipeline stage (api.py's `_stage`, on while
Config.profile / TBZ_TORCH_PROFILE=1 is set), and a torch.profiler
trace context for device timelines.

Unlike tbz, api.py ends each device stage with a synchronize of its
CUDA device while profiling is on, so a stage holds its kernels' time
and the stages of one call sum to the call.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0
    bytes: int = 0

    @property
    def gbps(self) -> float:
        return self.bytes / self.seconds / 1e9 if self.seconds else 0.0


@dataclass
class Metrics:
    stages: dict = field(default_factory=lambda: defaultdict(StageStats))
    # parallel/host.py times stages from many threads at once
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                s = self.stages[name]
                s.calls += 1
                s.seconds += dt
                s.bytes += nbytes

    def report(self) -> str:
        lines = []
        with self._lock:
            items = sorted(self.stages.items())
        for name, s in items:
            lines.append(f"{name:24s} {s.calls:6d} calls "
                         f"{s.seconds * 1000:9.1f} ms "
                         f"{s.gbps:7.2f} GB/s")
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self.stages.clear()


metrics = Metrics()


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """torch.profiler trace around a region: CPU activity, and CUDA
    activity when a card is present, written as a Chrome trace
    (trace_<pid>_<ns>.json) into trace_dir. Yields the profiler, whose
    key_averages() sums the region by op and kernel; a no-op yielding
    None when trace_dir is falsy."""
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
