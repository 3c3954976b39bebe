"""Stage timing + throughput metrics (SURVEY §5.1/§5.5 obligations).

The reference has only a dead *stats* table and commented format traces
(deflate.lisp:74,91). Here: a lightweight stage timer that aggregates
bytes/second per pipeline stage (`stage`, on while Config.profile /
TBZ_TORCH_PROFILE=1 is set), and a torch.profiler trace context for
device timelines.

`stage` is the one timer of the program: api.py's stages, the fused
route's spans inside `decode.fused` (ops/fused.py, ops/batched.py) and
the batch route's inside `decode.batch` (parallel/shard.py) all go
through it, and `collect_stats` reads the same spans; `count` adds a
route's counters to the report. Unlike tbz, a
timed stage on a CUDA device ends with a synchronize of it, so a stage
holds its kernels' time and the stages of one call sum to the call.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

from .config import get_config


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
    # counts a route keeps beside its stages (parallel/shard.py's)
    counters: dict = field(default_factory=lambda: defaultdict(int))
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

    def count(self, counts: dict) -> None:
        """Add each of `counts` (name -> int) to its counter."""
        with self._lock:
            for name, n in counts.items():
                self.counters[name] += n

    def report(self) -> str:
        lines = []
        with self._lock:
            items = sorted(self.stages.items())
            counters = sorted(self.counters.items())
        for name, s in items:
            lines.append(f"{name:24s} {s.calls:6d} calls "
                         f"{s.seconds * 1000:9.1f} ms "
                         f"{s.gbps:7.2f} GB/s")
        lines += [f"{name:24s} {n:12d}" for name, n in counters]
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self.stages.clear()
            self.counters.clear()


metrics = Metrics()


class Span:
    """What `stage` yields: `ms`, the stage's duration in ms once it has
    closed; 0.0 where nothing timed it."""
    __slots__ = ("ms",)

    def __init__(self):
        self.ms = 0.0


_UNTIMED = contextlib.nullcontext(Span())


def _sync(device) -> None:
    if device is not None and device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _timed(device):
    span = Span()
    t0 = time.perf_counter()
    yield span
    _sync(device)
    span.ms = (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def _profiled(name: str, nbytes: int, device):
    from torch.profiler import record_function
    # `metrics` is looked up here, at each stage: a caller may replace it
    with metrics.stage(name, nbytes), record_function(name), \
            _timed(device) as span:
        yield span


def stage(name: str, nbytes: int = 0, device=None, timed: bool = False):
    """The program's stage timer, as tbz/api.py's `_stage`.

    While Config.profile / TBZ_TORCH_PROFILE=1 is set: times the stage
    into `metrics` (`metrics.stage(name, nbytes)`) and annotates it for
    torch.profiler (`record_function(name)`), so a device_trace shows
    the stages on the kernels' clock. `timed` (a caller's collect_stats)
    times it without either. A timed stage on a CUDA `device` ends with
    a synchronize of it, so its kernels count in it. Yields a Span whose
    `ms` the stage's duration fills in. Otherwise it reads the config
    and does nothing else: no clock, no synchronize, no annotation."""
    if get_config().profile:
        return _profiled(name, nbytes, device)
    if timed:
        return _timed(device)
    return _UNTIMED


def count(counts: dict) -> None:
    """Under Config.profile, add `counts` to `metrics`' counters (its
    report lists them); otherwise nothing."""
    if get_config().profile:
        metrics.count(counts)


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
