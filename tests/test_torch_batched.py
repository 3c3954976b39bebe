"""Kernels 1-3 parity: one launch plan from tbz's _build_plan runs
through tbz's _batched_kernel (XLA on the CPU) and tbz_torch's (plain
PyTorch versions on the CPU). The metadata header and compact[:total]
must be exactly equal (tolerance 0: integers)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbz.native import loader as TL
from tbz.ops import batched as TB
from tbz.ops import speculative as TS
from tbz_torch.native import loader as PL
from tbz_torch.ops import batched as PB
from tbz_torch.ops import fused as PF
from tbz_torch.ops import tokenize_device as PD

from torch_util import (LANE_CASES, SCAN_CASES, assert_same_scan, corpus,
                        lane_case, mixed_blocks, raw_deflate, root_misses,
                        scan_cases, scan_survivors_plain, short_blocks)


@pytest.fixture(autouse=True, scope="module")
def _release_xla_executables():
    """Free tbz's compiled XLA executables after this module (each plan
    shape compiles _batched_kernel anew and holds hundreds of memory
    maps; the suite runs in one process under the kernel's limit of
    65530 maps)."""
    yield
    jax.clear_caches()


def _compare(payload: bytes):
    nbits = len(payload) * 8
    scan = TL.scan_headers(payload)
    assert len(scan[0]) > 0
    plan = TB._build_plan(nbits, scan, 8192)
    want = np.asarray(TB._launch(TS.stage_stream_device(payload), plan,
                                 nbits))
    dp = PB.plan_from_numpy(plan, "cpu")
    got = PB._batched_kernel(PB.stage_stream(payload, "cpu"), *dp, nbits,
                             plan.L, plan.S, plan.B, plan.n_out).numpy()
    hdr = plan.hdr_len
    assert np.array_equal(got[:hdr], want[:hdr])
    total = int(want[hdr - 1])
    assert np.array_equal(got[hdr:hdr + total], want[hdr:hdr + total])
    return PB._parse_meta(got[:hdr], plan)


@pytest.mark.parametrize("lvl", [1, 6, 9])
def test_levels(lvl):
    meta = _compare(raw_deflate(corpus(10 + lvl, 96 << 10), lvl))
    assert meta.total > 0


def test_forced_junctions(monkeypatch):
    """EXT_BITS = 8 in both modules: lanes barely overlap, so most
    junctions are dead and the flags/handoff logic is exercised."""
    monkeypatch.setattr(TB, "EXT_BITS", 8)
    monkeypatch.setattr(PB, "EXT_BITS", 8)
    meta = _compare(raw_deflate(corpus(30, 96 << 10), 9))
    assert np.any(meta.flags & PB.F_DEAD)


def test_mixed_blocks():
    """Stored and static blocks between dynamic ones: the scanner's
    candidates there include false positives the walk culls."""
    _compare(mixed_blocks(20))


def test_device_plan_roundtrip():
    payload = raw_deflate(corpus(3, 32 << 10), 6)
    plan = TB._build_plan(len(payload) * 8, TL.scan_headers(payload), 8192)
    dp = PB.plan_from_numpy(plan, "cpu")
    for name in PB.DevicePlan._fields:
        t = getattr(dp, name)
        assert t.dtype == torch.int32
        assert np.array_equal(t.numpy(), getattr(plan, name))


@pytest.mark.parametrize("ext_bits", [PB.EXT_BITS, 8])
@pytest.mark.parametrize("seed", [1, 2])
def test_short_blocks(monkeypatch, seed, ext_bits):
    """Many short dynamic blocks (a flush every 200-3000 bytes): lanes
    that end at an end-of-block (skip), segments that start inside a
    lane run, lanes under HEAD + TAIL symbols, empty stored blocks; and
    with EXT_BITS = 8 in both modules (barely overlapping lanes)."""
    monkeypatch.setattr(TB, "EXT_BITS", ext_bits)
    monkeypatch.setattr(PB, "EXT_BITS", ext_bits)
    meta = _compare(short_blocks(seed, 96 << 10))
    assert np.any(meta.flags & PB.F_SKIP)


@functools.lru_cache(maxsize=None)
def _jax_lanes(L: int, S: int):
    return jax.jit(functools.partial(TB._lanes_multi, L=L, S=S))


@pytest.mark.parametrize("case", LANE_CASES,
                         ids=[f"seed{c[0]}-L{c[1]}-S{c[2]}" for c in
                              LANE_CASES])
def test_lanes_multi_edge_inputs(case):
    """_lanes_multi alone against tbz's on adversarial inputs: codes of
    11-15 bits in both alphabets, a single 1-bit code, over-subscribed,
    incomplete and all-zero tables, a shuffled tbl_idx, lanes that start
    at or past total_bits, an odd L, and the speculative tier's shape
    (B = 1, L = 1, 7, 256, S = 384). The same tables (the port's plain
    build) go into both."""
    (lit, dist), (d32, tbl, st, en, total_bits, S) = lane_case(case)
    lt, dt, _, _ = PD.build_flat_table(lit, dist)
    mine = PB._lanes_multi(d32, lt, dt, tbl, st, en, total_bits, S)
    L = st.shape[0]
    want = _jax_lanes(L, S)(
        jnp.asarray(d32.numpy().view(np.uint32)),
        jnp.asarray(lt.numpy().view(np.uint32).reshape(-1)),
        jnp.asarray(dt.numpy().view(np.uint32).reshape(-1)),
        jnp.asarray(tbl.numpy() << 15), jnp.asarray(st.numpy()),
        jnp.asarray(en.numpy()), total_bits)
    for k, (m, w) in enumerate(zip(mine, want)):
        m = m.t() if k < 3 else m
        assert np.array_equal(m.numpy().astype(np.int64),
                              np.asarray(w).astype(np.int64))
    lookups, misses = root_misses(d32, lt, dt, tbl, mine[0], mine[1])
    assert lookups > 0
    if L > 1:
        assert misses > 0
    if not case[3]:
        assert (mine[3][st >= total_bits] == st[st >= total_bits]).all()
        assert not mine[4][st >= total_bits].any()


@pytest.mark.parametrize("name", SCAN_CASES)
def test_scan_headers_on_cpu_is_the_host_scan(name):
    """The scan wrapper on a CPU tensor (the port's host scan, which the
    card test holds the kernel to) returns tbz's host scan's tuple, and
    counts the pre-filter's survivors as the plain count does."""
    body = scan_cases()[name]
    stats = {}
    got = PB.scan_headers(PB.stage_stream(body, "cpu"), len(body), stats)
    assert_same_scan(got, TL.scan_headers(body), zero_tail=False)
    assert stats["scan_survivors"] == scan_survivors_plain(body)


def _precode_plausible(bits: np.ndarray, hb: int) -> bool:
    """frontend.cc precode_plausible, one position, on a bit array."""
    def field(off, k):
        return sum(int(bits[hb + off + t]) << t for t in range(k))
    if field(0, 5) > 29 or field(5, 5) > 29:
        return False
    counts = [0] * 8
    for i in range(field(10, 4) + 4):
        counts[field(14 + 3 * i, 3)] += 1
    left = 1
    for length in range(1, 8):
        left = 2 * left - counts[length]
        if left < 0:
            return False
    return left == 0


@pytest.mark.parametrize("kind", ["random", "zlib6", "truncated"])
def test_scan_survivors_plain_counts_the_prefilter(kind):
    """torch_util.scan_survivors_plain (chunks of 1000 positions) and
    native.loader.scan_survivors against a position-by-position count of
    the BTYPE test and precode_plausible, zero past the body's end."""
    rng = np.random.default_rng(7)
    body = {"random": rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
            "zlib6": raw_deflate(corpus(9, 12 << 10), 6),
            "truncated": raw_deflate(corpus(9, 12 << 10), 6)[:40]}[kind]
    bits = np.concatenate([np.unpackbits(np.frombuffer(body, np.uint8),
                                         bitorder="little"),
                           np.zeros(128, np.uint8)])
    want = sum(1 for p in range(len(body) * 8 - 17)
               if bits[p + 1] == 0 and bits[p + 2] == 1
               and _precode_plausible(bits, p + 3))
    assert want > 0
    assert scan_survivors_plain(body, chunk=1000) == want
    assert PL.scan_survivors(body) == want


def test_fused_stats_report_scan_survivors():
    """collect_stats on the CPU: `candidates` is the host scan's count,
    and `scan_survivors` the positions that reached the full parse."""
    body = raw_deflate(corpus(12, 160 << 10), 6)
    *_, st = PF.decode_stream_fused(body, collect_stats=True, device="cpu")
    assert st["candidates"] == len(PL.scan_headers(body)[0]) > 0
    assert st["scan_survivors"] == scan_survivors_plain(body)
    assert st["scan_survivors"] > st["candidates"]
