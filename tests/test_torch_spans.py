"""The fused route's spans inside `decode.fused` (utils.profiling.stage),
on the CPU: under Config.profile, eight `fused.*` spans nested in
`decode.fused`, recorded through a stand-in for utils.profiling.metrics
that takes only `stage(name, nbytes)`, as the benchmark's traced runs
replace it; with profiling off, no span, no clock read and no
synchronize; under collect_stats, each `*_ms` entry the duration of its
span."""

import contextlib
import dataclasses
import gzip
import time

import pytest

import tbz_torch
from tbz_torch.ops import fused as PF
from tbz_torch.utils import config as PC
from tbz_torch.utils import profiling as PP

from torch_util import corpus

DATA = corpus(211, 1 << 20)
PAYLOAD = gzip.compress(DATA, 6)   # a body of 292 KiB: the fused route
BODY = PAYLOAD[10:]   # past the header, as api.py hands the body on

SPANS = ("fused.upload", "fused.scan", "fused.plan", "fused.kernels",
         "fused.meta", "fused.walk", "fused.splice", "fused.fetch")
# each stats entry and the span it reads
STATS_MS = {"upload_ms": "fused.upload", "scan_ms": "fused.scan",
            "plan_ms": "fused.plan", "kernel_ms": "fused.kernels",
            "fetch_ms": "fused.meta", "walk_ms": "fused.walk",
            "resolve_ms": "fused.splice", "out_fetch_ms": "fused.fetch"}
COUNTS = ("fetches", "candidates", "scan_survivors", "blocks", "spliced",
          "gap_blocks", "gap_syms", "joins", "meta_d2h_bytes",
          "out_d2h_bytes", "passes")

_clock = time.perf_counter


class Recorder:
    """Stands in for profiling.metrics: only stage(name, nbytes), each
    span kept as (name, nbytes, t0, t1) on the host clock."""

    def __init__(self, inner):
        self.inner = inner
        self.spans: list = []

    @contextlib.contextmanager
    def stage(self, name, nbytes):
        t0 = _clock()
        try:
            with self.inner.stage(name, nbytes):
                yield
        finally:
            self.spans.append((name, nbytes, t0, _clock()))


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder(PP.Metrics())
    monkeypatch.setattr(PP, "metrics", rec)
    return rec


@pytest.fixture
def profile():
    """profile(on) sets Config.profile; the config is restored after."""
    saved = PC.get_config()

    def set_profile(on):
        PC.set_config(dataclasses.replace(saved, profile=on))
    yield set_profile
    PC.set_config(saved)


def test_eight_spans_nest_in_decode_fused(recorder, profile):
    profile(True)
    assert tbz_torch.decompress(PAYLOAD, device="cpu") == DATA
    spans = [s for s in recorder.spans if s[0] != "verify.crc32"]
    outer = [s for s in spans if s[0] == "decode.fused"]
    assert len(outer) == 1
    _, nbytes, a, b = outer[0]
    assert nbytes == len(BODY)
    inner = sorted((s for s in spans if s[0] != "decode.fused"),
                   key=lambda s: s[2])
    assert [s[0] for s in inner] == list(SPANS)
    for (name, n, t0, t1), (_, _, n0, _) in zip(inner, inner[1:]):
        assert a <= t0 <= t1 <= n0 <= b, name
    assert a <= inner[-1][2] <= inner[-1][3] <= b
    assert [s[1] for s in inner] == [len(BODY)] * 6 + [len(DATA)] * 2
    covered = sum(t1 - t0 for _, _, t0, t1 in inner)
    assert covered >= 0.9 * (b - a), (covered, b - a)


def test_profiling_off_reads_no_clock_and_calls_no_synchronize(
        recorder, profile, monkeypatch):
    clock_reads, syncs = [], []

    def clock():
        clock_reads.append(1)
        return _clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    monkeypatch.setattr(PP, "_sync", lambda device: syncs.append(device))
    profile(False)
    assert tbz_torch.decompress(PAYLOAD, device="cpu") == DATA
    out, *_ = PF.decode_stream_fused(BODY, device="cpu")
    assert out == DATA
    assert recorder.spans == [] and clock_reads == [] and syncs == []
    # the same stubs see a timed decode: a clock, and a synchronize at
    # the end of each device span (upload, scan, kernels, splice)
    out, *_, stats = PF.decode_stream_fused(BODY, collect_stats=True,
                                            device="cpu")
    assert out == DATA and recorder.spans == []
    assert clock_reads and len([d for d in syncs if d is not None]) == 4
    assert all(stats[k] > 0 for k in STATS_MS)


def test_collect_stats_reads_the_spans(recorder, profile):
    profile(False)
    *_, quiet = PF.decode_stream_fused(BODY, collect_stats=True,
                                       device="cpu")
    profile(True)
    out, *_, stats = PF.decode_stream_fused(BODY, collect_stats=True,
                                            device="cpu")
    assert out == DATA
    assert set(stats) == set(STATS_MS) | set(COUNTS)
    assert {k: stats[k] for k in COUNTS} == {k: quiet[k] for k in COUNTS}
    assert stats["out_d2h_bytes"] > len(DATA) and stats["passes"] > 0
    spans = {name: (t1 - t0) * 1e3 for name, _, t0, t1 in recorder.spans}
    assert set(spans) == set(SPANS)
    for key, name in STATS_MS.items():
        # the recorder's clock reads sit just outside the span's own
        assert 0 < stats[key] <= spans[name] <= stats[key] + 1.0, key
