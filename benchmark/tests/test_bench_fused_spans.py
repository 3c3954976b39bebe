"""The readers of the fused route's spans nested in `decode.fused`, on
hand-made calls: the four ms metrics split the covered part of
fused_ms_per_MiB.stream, and each reader is silent where no call took
the fused route or the program times no span inside it."""

import importlib.util
import os

import pytest

from conftest import BENCH
from record import MIB, Call, Window

MS = ("fused_scan_ms_per_MiB", "fused_walk_ms_per_MiB",
      "fused_kernels_ms_per_MiB", "fused_transfer_ms_per_MiB")
READERS = MS + ("fused_unspanned_pct",)


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"),
        os.path.join(BENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fused_call(t, in_mib, out_mib, gap):
    """A call on the fused route from t: decode.fused of 0.4 s, the
    eight spans inside it in order, `gap` s of it outside every span,
    then verify."""
    lengths = (0.01, 0.09, 0.02, 0.01, 0.005, 0.2, 0.015, 0.05)
    scale = (0.4 - gap) / sum(lengths)
    spans, at = [], t + gap / 2
    for name, d in zip(("upload", "scan", "plan", "kernels", "meta", "walk",
                        "splice", "fetch"), lengths):
        spans.append(("fused." + name, at, at + d * scale))
        at += d * scale
    spans += [("decode.fused", t, t + 0.4), ("verify.crc32", t + 0.4,
                                             t + 0.45)]
    return Call(t, t + 0.5, [0], None, in_mib * MIB, out_mib * MIB, spans)


def declined_call(t):
    return Call(t, t + 0.1, [1], None, MIB // 2, MIB,
                [("decode.fused", t, t + 0.01), ("fused.upload", t, t + 0.002),
                 ("fused.scan", t + 0.002, t + 0.008),
                 ("tokenize", t + 0.01, t + 0.03),
                 ("resolve.device", t + 0.03, t + 0.08)])


@pytest.mark.parametrize("gaps", [(0.0, 0.0), (0.004, 0.0), (0.01, 0.03)])
def test_the_four_split_the_covered_part_of_the_stage(gaps):
    calls = [fused_call(10.0, 3, 8, gaps[0]), declined_call(10.5),
             fused_call(10.6, 1, 2, gaps[1])]
    w = Window(calls, 10.0, 11.2, 7.5)
    fused = reader("fused_ms_per_MiB.stream").read(w)
    assert fused == pytest.approx(0.8 * 1e3 / 10)
    unspanned = reader("fused_unspanned_pct").read(w)
    assert unspanned == pytest.approx(100 * sum(gaps) / 0.8)
    parts = [reader(m).read(w) for m in MS]
    assert sum(parts) == pytest.approx(fused * (1 - unspanned / 100))
    # the walk is 0.2 of the 0.4 s the eight lengths sum to
    assert parts[1] == pytest.approx(
        sum(0.2 / 0.4 * (0.4 - g) for g in gaps) * 1e3 / 10)


def test_spans_outside_decode_fused_are_not_counted():
    c = fused_call(10.0, 3, 8, 0.04)
    c.spans.append(("fused.walk", 10.45, 10.48))   # after the stage
    w = Window([c], 10.0, 10.5, 1.0)
    assert reader("fused_unspanned_pct").read(w) == pytest.approx(10.0)


@pytest.mark.parametrize("name", READERS)
def test_silent_where_no_call_took_the_fused_route(name):
    w = Window([declined_call(0.0), declined_call(0.2)], 0.0, 0.5, 1.0)
    assert reader(name).read(w) is None
    assert reader(name).read(Window([], 0.0, 1.0, 1.0)) is None


@pytest.mark.parametrize("name", READERS)
def test_silent_where_the_program_times_nothing_inside(name):
    # a program without the spans: decode.fused alone
    w = Window([Call(0.0, 0.5, [0], None, MIB, 4 * MIB,
                     [("decode.fused", 0.0, 0.4)])], 0.0, 0.5, 1.0)
    assert reader("fused_ms_per_MiB.stream").read(w) is not None
    assert reader(name).read(w) is None
