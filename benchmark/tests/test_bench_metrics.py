"""The metric arithmetic, on hand-made calls, stages and device rows."""

import importlib.util
import os

import pytest

import devtrace
from conftest import BENCH
from record import MIB, Call, Window


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"),
        os.path.join(BENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def window(device=None, peak=None):
    # a fused call of 8 MiB, a declined call of 1 MiB, a probe of 2 MiB
    # on the fused route
    calls = [
        Call(10.0, 10.5, [0], None, 3 * MIB, 8 * MIB,
             [("decode.fused", 10.0, 10.4), ("verify.crc32", 10.4, 10.45)]),
        Call(10.5, 10.6, [1], None, MIB // 2, MIB,
             [("tokenize", 10.5, 10.52), ("resolve.device", 10.52, 10.58),
              ("verify.adler32", 10.58, 10.59)]),
        Call(10.6, 10.8, [2], 0, MIB, 2 * MIB,
             [("decode.fused", 10.6, 10.7), ("verify.crc32", 10.7, 10.72)]),
    ]
    return Window(calls, 10.0, 11.0, 7.5, device, peak)


def test_end_to_end():
    w = window()
    assert reader("decode_GBps").read(w) == pytest.approx(11 * MIB / 1e9)
    assert reader("decode_GBps.stream").read(w) == \
        pytest.approx(11 * MIB / 1e9)
    assert reader("setup_s").read(w) == 7.5
    assert reader("call_p95_ms").read(w) == pytest.approx(500.0)


def test_p95_is_the_nearest_rank():
    calls = [Call(0, i / 1000, [0], None, 1, 1) for i in range(1, 101)]
    w = Window(calls, 0, 1, 0)
    assert reader("call_p95_ms").read(w) == pytest.approx(95.0)
    w = Window(calls[:10], 0, 1, 0)
    assert reader("call_p95_ms").read(w) == pytest.approx(10.0)


def test_stage_metrics_take_each_route_apart():
    w = window()
    fused = (0.4 + 0.1) * 1e3 / 10
    assert reader("fused_ms_per_MiB.stream").read(w) == pytest.approx(fused)
    assert reader("fused_ms_per_MiB.bodies").read(w) == pytest.approx(fused)
    assert reader("declined_tokenize_ms_per_MiB").read(w) == \
        pytest.approx(20.0)
    assert reader("declined_resolve_ms_per_MiB").read(w) == \
        pytest.approx(60.0)
    assert reader("verify_ms_per_MiB").read(w) == \
        pytest.approx((50 + 10 + 20) / 11)


def test_a_route_no_call_took_reads_nothing():
    w = Window([Call(0, 1, [0], None, 1, MIB,
                     [("decode.fused", 0, 0.5)])], 0, 1, 0)
    assert reader("declined_tokenize_ms_per_MiB").read(w) is None
    assert reader("declined_resolve_ms_per_MiB").read(w) is None
    assert reader("verify_ms_per_MiB").read(w) is None
    for name in ("copy_ms_per_MiB", "device_idle_pct", "kernels_roofline",
                 "kernel_ms_per_MiB"):
        assert reader(name).read(w) is None   # no device trace


def trace():
    ops = [("kernel_a", 10.10, 10.20),
           ("kernel_b", 10.15, 10.25),          # overlaps kernel_a
           ("Memcpy HtoD (Pageable -> Device)", 10.30, 10.35),
           ("Memset (Device)", 10.35, 10.36),
           ("kernel_a", 10.90, 11.20)]          # runs past the window
    return devtrace.DeviceTrace(ops, 10.0, 11.0)


def test_device_trace_union_and_kinds():
    t = trace()
    assert t.busy_s() == pytest.approx(0.15 + 0.06 + 0.10)
    assert t.seconds("kernel") == pytest.approx(0.1 + 0.1 + 0.3)
    assert t.seconds("copy") == pytest.approx(0.05)
    assert t.seconds("memset") == pytest.approx(0.01)
    gaps = t.idle_gaps()
    assert gaps[0] == pytest.approx((10.0, 10.10))
    assert sum(b - a for a, b in gaps) == pytest.approx(1 - t.busy_s())
    top = t.top_ops(2)
    assert top[0][0] == "kernel_a" and top[0][1] == pytest.approx(0.4)


def test_device_metrics():
    w = window(trace(), 3.35e12)
    assert reader("device_idle_pct").read(w) == pytest.approx(69.0)
    assert reader("copy_ms_per_MiB").read(w) == pytest.approx(50 / 11)
    # 0.5 s of kernel rows, the one past the window's end whole
    assert reader("kernel_ms_per_MiB").read(w) == pytest.approx(500 / 11)
    # (4.5 MiB in + 11 MiB out) / 3.35 TB/s over 0.5 s of kernels
    rl = reader("kernels_roofline")
    least = rl.least_bytes(w.calls)
    assert least == 4.5 * MIB + 11 * MIB
    assert rl.read(w) == pytest.approx(100 * least / 3.35e12 / 0.5)
    assert rl.share_pct(3_350_000, 3.35e12, 1e-6) == pytest.approx(100.0)
    assert rl.share_pct(1, 3.35e12, 0.0) is None


def test_idle_gaps_by_what_the_host_did():
    w = window(trace())
    by = dict(devtrace.idle_by_host(w.device, w.calls))
    # idle: 10.00-10.10, 10.25-10.30, 10.36-10.90
    assert by["decode.fused"] == pytest.approx(0.10 + 0.05 + 0.04 + 0.10)
    assert by["verify.crc32"] == pytest.approx(0.05 + 0.02)
    assert by["tokenize"] == pytest.approx(0.02)
    assert by["resolve.device"] == pytest.approx(0.06)
    assert by["verify.adler32"] == pytest.approx(0.01)
    assert by["call, outside the stages"] == pytest.approx(0.05 + 0.01 + 0.08)
    assert by["between calls"] == pytest.approx(0.10)
    assert sum(by.values()) == pytest.approx(0.69)


def test_host_segments_cover_the_window():
    w = window()
    segs = devtrace.host_segments(w.calls, 9.5, 11.0)
    assert segs[0] == (9.5, 10.0, "between calls")
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    assert segs[-1][1] == 11.0
