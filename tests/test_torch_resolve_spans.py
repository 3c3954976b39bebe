"""The flat span resolver's plain version against
tbz.ops.resolve_spans._resolve_flat_impl (XLA on the CPU) on one staged
plan, and byte-identical to stdlib zlib across stored runs, a preset
window, deep overlap chains and the G / K / seg_rows variants of
tests/test_resolve_flat.py. Tolerance 0: bytes."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbz.native import loader as TL
from tbz.ops import resolve_spans as TS
from tbz_torch import reference as PR
from tbz_torch.native import loader as PL
from tbz_torch.ops import resolve_spans as PS

from torch_util import corpus, raw_deflate


@pytest.fixture(autouse=True, scope="module")
def _release_xla_executables():
    """Free tbz's compiled XLA executables after this module: each holds
    hundreds of memory maps, and the whole suite runs in one process,
    under the kernel's limit of 65530 maps."""
    yield
    jax.clear_caches()


def _roundtrip(data, level=9, window=b"", **kw):
    payload = raw_deflate(data, level, zdict=window or None)
    res = PR.tokenize_host(payload, 0, window_len=len(window))
    return PS.resolve_flat_bytes(res.tape, payload, window, device="cpu",
                                 **kw)


def test_plain_matches_tbz_on_one_staged_plan():
    """tbz's staged (padded) arguments through both packages: the same
    output rows over [0, total_out)."""
    zdict = corpus(70, 6000)
    data = zdict[:2000] + corpus(71, 40000) + b"ab" * 3000
    payload = raw_deflate(data, 6, zdict=zdict)
    res = PR.tokenize_host(payload, 0, window_len=len(zdict))
    plan = TL.plan_spans_flat(res.tape, payload, window_len=len(zdict),
                              G=1024, K=2, seg_rows=128)
    args, n_rows = TS.stage_flat_plan(plan, zdict)
    want = TS._resolve_flat_impl(*(jnp.asarray(a) for a in args), n_rows,
                                 plan.seg_rows)
    want = np.asarray(want).view(np.uint8).reshape(-1)[:plan.total_out]
    got = PS._resolve_flat_impl(PS.flat_plan_from_numpy(args, "cpu"))
    assert len(PS.flat_plan_from_numpy(args, "cpu").seg_base) > 1
    assert got[:plan.total_out].numpy().tobytes() == want.tobytes() == data


def test_port_planner_equals_tbz():
    """The port's copy of the C++ planner gives tbz's plan."""
    payload = raw_deflate(corpus(72, 50000), 9)
    tape = PR.tokenize_host(payload, 0).tape
    a = TL.plan_spans_flat(tape, payload, G=512, K=4, seg_rows=256)
    b = PL.plan_spans_flat(tape, payload, G=512, K=4, seg_rows=256)
    for f in ("srcaddr", "lenoff", "g_row", "b_segrow", "out0"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (a.n_batches, a.total_out, a.n_spans, a.seg_rows) == \
        (b.n_batches, b.total_out, b.n_spans, b.seg_rows)


@pytest.mark.parametrize("name,data", [
    ("empty", b""),
    ("one", b"x"),
    ("run", b"a" * 70000),
    ("repeat", b"hello world " * 6000),
    ("text", corpus(73, 1 << 16)),
])
def test_classes(name, data):
    assert _roundtrip(data) == data


def test_stored_runs():
    data = corpus(74, 50000)
    payload = raw_deflate(data, 0)
    tape = PR.tokenize_host(payload, 0).tape
    assert PS.resolve_flat_bytes(tape, payload, device="cpu") == data


def test_preset_dictionary_window():
    data = corpus(75, 30000)
    assert _roundtrip(data, window=corpus(76, 4000)) == data
    assert _roundtrip(data, window=corpus(77, 40000)[-32768:]) == data


def test_deep_overlap_chains():
    data = (b"\x00" * 1000 + b"ab" * 700 + b"xyz" * 500) * 12
    assert _roundtrip(data) == data


@pytest.mark.parametrize("G,K", [(512, 4), (1024, 2), (2048, 4), (4096, 2)])
def test_shape_variants(G, K):
    data = corpus(78, 1 << 16)
    assert _roundtrip(data, G=G, K=K) == data


@pytest.mark.parametrize("seg_rows", [64, 256, 8192])
def test_segment_variants(seg_rows):
    # 1 << 16 output = 512 rows: 64 forces 8 segments, 256 forces 2,
    # 8192 clamps to the single-segment case
    data = corpus(79, 1 << 16)
    assert _roundtrip(data, 9, seg_rows=seg_rows) == data


def test_plan_too_large_raises_value_error():
    """Outputs of 2 GB - 64 KB and more are refused before planning (the
    caller then resolves by pointer doubling)."""
    from tbz_torch.tape import TokenTape
    n = 9000
    tape = TokenTape(out_len=np.full(n, 258, np.int32),
                     dist=np.ones(n, np.int32), root_val=np.zeros(n, np.int32),
                     total_out=(1 << 31))
    with pytest.raises(ValueError):
        PL.plan_spans_flat(tape, b"")


def test_window_right_aligned():
    args = PS.stage_flat_plan(PL.plan_spans_flat(
        PR.tokenize_host(raw_deflate(b"abc", 6), 0).tape, b""), b"xyz")
    w = args[-1]
    assert w.shape == (PS.W,) and w[-3:].tobytes() == b"xyz"
    assert not w[:-3].any()
    assert torch.equal(PS.flat_plan_from_numpy(args, "cpu").window,
                       torch.from_numpy(w))


@pytest.mark.parametrize("G,K,seg_rows,window", [
    (1024, 2, 2048, False),   # tests/test_resolve_flat.py:149's plan
    (512, 4, 256, True),      # several segments, a preset window
])
def test_scan_and_gscat_layouts_equal_tbz(G, K, seg_rows, window):
    """tbz's two baseline formulations and the port's counterparts on
    tbz's staged (shape-padded) arguments: the same output rows, which
    hold zlib's bytes."""
    zdict = corpus(81, 5000) if window else b""
    data = (zdict[:1500] if window else b"") + corpus(33, 3 << 16)
    payload = raw_deflate(data, 6, zdict=zdict or None)
    res = PR.tokenize_host(payload, 0, window_len=len(zdict))
    plan = TL.plan_spans_flat(res.tape, payload, window_len=len(zdict), G=G,
                              K=K, seg_rows=seg_rows)
    np_args, n_rows = TS.stage_flat_plan(plan, zdict)
    NB_pad = np_args[0].shape[0]
    assert NB_pad > plan.n_batches          # tbz's shape padding is in
    b_segrow = np.full(NB_pad, TS.W_ROWS, np.int32)
    b_segrow[:plan.n_batches] = plan.b_segrow
    g_glob = (np_args[2] + b_segrow[:, None]).astype(np.int32)
    j = [jnp.asarray(a) for a in np_args]
    want_scan = TS._resolve_flat_scan_impl(
        j[0], j[1], j[2], jnp.asarray(b_segrow), j[6], j[7], n_rows,
        plan.seg_rows)
    want_gscat = TS._resolve_flat_gscat_impl(
        j[0], j[1], jnp.asarray(g_glob), j[6], j[7], n_rows)
    scan = PS._resolve_flat_scan_impl(
        np_args[0], np_args[1], np_args[2], b_segrow, np_args[6],
        np_args[7], n_rows, plan.seg_rows, device="cpu")
    gscat = PS._resolve_flat_gscat_impl(
        np_args[0], np_args[1], g_glob, np_args[6], np_args[7], n_rows,
        device="cpu")
    for got, want in ((scan, want_scan), (gscat, want_gscat)):
        want = np.asarray(want).view(np.uint8).reshape(-1)
        assert got.numpy().tobytes() == want.tobytes()
        assert want[:plan.total_out].tobytes() == data


def test_baseline_layouts_check_shapes():
    payload = raw_deflate(corpus(82, 20000), 6)
    plan = TL.plan_spans_flat(PR.tokenize_host(payload, 0).tape, payload,
                              G=512, K=2, seg_rows=64)
    a, n_rows = TS.stage_flat_plan(plan)
    b_segrow = np.full(a[0].shape[0], TS.W_ROWS, np.int32)
    with pytest.raises(ValueError):        # one b_segrow a batch
        PS._resolve_flat_scan_impl(a[0], a[1], a[2], b_segrow[:-1], a[6],
                                   a[7], n_rows, 64, device="cpu")
    with pytest.raises(ValueError):        # live rows outside the segment
        PS._resolve_flat_scan_impl(a[0], a[1], a[2] + 64, b_segrow, a[6],
                                   a[7], n_rows, 64, device="cpu")
    with pytest.raises(ValueError):        # out0 of another row count
        PS._resolve_flat_gscat_impl(a[0], a[1], a[2], a[6], a[7],
                                    n_rows + 1, device="cpu")


def test_batch_bases():
    """The card kernel's per-batch segment bases (the wrapper's host
    table): each batch of a segment gets its base row, batches in no
    segment (tbz's shape padding) -1, and a batch in two segments is
    refused."""
    args = PS.stage_flat_plan(PL.plan_spans_flat(
        PR.tokenize_host(raw_deflate(corpus(80, 1 << 16), 9), 0).tape, b"",
        seg_rows=64))
    fa = PS.flat_plan_from_numpy(args, "cpu")
    base = PS._batch_bases(fa)
    assert len(fa.seg_base) > 1 and base.shape == (fa.srcaddr.shape[0],)
    for lo, hi, b in zip(fa.seg_lo, fa.seg_hi, fa.seg_base):
        assert (base[lo:hi] == b).all()
    gap = fa._replace(seg_lo=fa.seg_lo[1:].copy(), seg_hi=fa.seg_hi[1:].copy(),
                      seg_base=fa.seg_base[1:].copy())
    assert (PS._batch_bases(gap)[:fa.seg_hi[0]] == -1).all()
    two = fa._replace(seg_lo=np.r_[fa.seg_lo, 0].astype(np.int32),
                      seg_hi=np.r_[fa.seg_hi, 1].astype(np.int32),
                      seg_base=np.r_[fa.seg_base, 7].astype(np.int32))
    with pytest.raises(ValueError):
        PS._batch_bases(two)
