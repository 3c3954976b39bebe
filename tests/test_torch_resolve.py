"""Kernel 4 core parity: tbz_torch's resolve_bytes (plain PyTorch on the
CPU) against tbz.ops.resolve.resolve_bytes (XLA on the CPU) and zlib.
Bytes must be identical (tolerance 0), and so must the doubling pass
counts on the adversarial tapes of torch_util.resolve_case."""

import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tbz.ops import gather as TG
from tbz.ops import resolve as TR
from tbz_torch import reference as PRef
from tbz_torch.ops import resolve as PR
from tbz_torch.tape import TokenTape

from torch_util import (RESOLVE_KINDS, corpus, deepest_chain, raw_deflate,
                        resolve_case)


@pytest.fixture(autouse=True, scope="module")
def _release_xla_executables():
    """Free tbz's compiled XLA executables after this module (each holds
    hundreds of memory maps; the suite runs in one process)."""
    yield
    jax.clear_caches()


def tbz_pass_count(monkeypatch, fn, *args):
    """Run a tbz resolve function eagerly (jax.disable_jit: the doubling
    while_loop runs in Python) and count its passes: the calls of
    gather.take1d(p, p) in its loop body. Returns (passes, its output)."""
    calls = []
    orig = TG.take1d

    def spy(x, idx, emu=False):
        if x is idx:
            calls.append(1)
        return orig(x, idx, emu)

    monkeypatch.setattr(TG, "take1d", spy)
    with jax.disable_jit():
        out = fn(*args)
    monkeypatch.setattr(TG, "take1d", orig)
    return len(calls), np.asarray(out)


def padded_args(tape, inp: bytes, window: bytes):
    """The padded arrays both packages' resolve cores take for `tape`:
    (out_len, dist, root_val int32[T], n_tokens, input uint8, window
    uint8[W], cap)."""
    n = len(tape)
    T = PR._pad_pow2(n)

    def pad(a):
        return np.pad(np.asarray(a, np.int32), (0, T - n))

    inp = np.frombuffer(inp or b"\0", np.uint8).copy()
    return (pad(tape.out_len), pad(tape.dist), pad(tape.root_val), n, inp,
            PR.window_tensor(window, "cpu").numpy(),
            PR._pad_pow2(tape.total_out, floor=4096))


def _check(payload: bytes, window: bytes = b"") -> bytes:
    res = PRef.tokenize_host(payload, 0, window_len=len(window))
    got = PR.resolve_bytes(res.tape, payload, window, device="cpu")
    assert got == TR.resolve_bytes(res.tape, payload, window)
    want = zlib.decompressobj(-15, zdict=window) if window else \
        zlib.decompressobj(-15)
    assert got == want.decompress(payload)
    return got


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_levels(level):
    _check(raw_deflate(corpus(21, 48 << 10), level))


def test_stored_runs_mixed_with_huffman():
    data = np.random.default_rng(5).integers(0, 256, 50000,
                                             dtype=np.uint8).tobytes()
    _check(raw_deflate(data + corpus(6, 20000), 1))


def test_window_carry():
    rng = np.random.default_rng(6)
    hist = rng.integers(32, 127, 40000, dtype=np.uint8).tobytes()
    payload = raw_deflate(hist[-1000:] * 3 + corpus(7, 4000), 9, zdict=hist)
    _check(payload, hist)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 100])
def test_overlap_distances(d):
    _check(raw_deflate(b"0123456789abcdefghijklmnopqrstuvwxyz"[:d] * 500, 9))


def test_rle_pass_bound():
    """dist=1 runs: the intra-token chain collapse keeps the genealogy
    shallow, so the doubling passes stay within ceil(log2(total)) + 2."""
    rng = np.random.default_rng(8)
    ol, di, rv, data = [], [], [], []
    for b, n in zip(rng.integers(0, 256, 300), rng.integers(200, 2000, 300)):
        ol.append(1), di.append(0), rv.append(int(b))
        for k in range(1, int(n), 258):      # literal, then dist=1 matches
            ol.append(min(258, int(n) - k)), di.append(1), rv.append(0)
        data.append(bytes([int(b)]) * int(n))
    tape = TokenTape.from_lists(ol, di, rv)
    data = b"".join(data)
    out, total, passes = PR.resolve_device(tape, b"", device="cpu",
                                           collect_stats=True)
    assert out[PR.W:PR.W + total].numpy().tobytes() == data
    assert TR.resolve_bytes(tape, b"\0") == data
    assert passes <= math.ceil(math.log2(total)) + 2


def test_empty_and_hand_built_tape():
    assert _check(raw_deflate(b"")) == b""
    # literal, overlapping match into the window, stored run
    tape = TokenTape.from_lists([1, 5, 3], [0, 2, 0],
                                [ord("x"), 0, (1 << 30) | 1])
    got = PR.resolve_bytes(tape, b"\x00abc", window=b"W", device="cpu")
    assert got == b"xWxWxWabc"


@pytest.mark.parametrize("kind", RESOLVE_KINDS)
def test_adversarial_tapes_equal_tbz(monkeypatch, kind):
    """The port's plain resolve against tbz's _resolve_impl on the 1 MiB
    adversarial tapes (a distance-1 run 19 passes deep, chains at
    distance 32768 into a preset window, stored runs between matches):
    the same bytes and the same doubling pass count."""
    tape, inp, win, want = resolve_case(kind, 1)
    out, total, passes = PR.resolve_device(tape, inp, win, device="cpu",
                                           collect_stats=True)
    assert out[PR.W:PR.W + total].numpy().tobytes() == want
    ol, di, rv, n, ib, wb, cap = padded_args(tape, inp, win)
    args = (jnp.asarray(ol), jnp.asarray(di), jnp.asarray(rv), jnp.int32(n),
            jnp.int32(total), jnp.asarray(ib), jnp.asarray(wb), cap)
    ref = np.asarray(TR._resolve_impl(*args))
    assert np.array_equal(ref[:PR.W + total],
                          out[:PR.W + total].numpy())
    tbz_passes, eager = tbz_pass_count(monkeypatch, TR._resolve_impl, *args)
    assert np.array_equal(eager, ref)
    assert passes == tbz_passes


def _count_cases():
    cases = [(k,) + resolve_case(k, 2, 1 << 18)[:3] for k in RESOLVE_KINDS]
    for level in (0, 1, 6, 9):
        payload = raw_deflate(corpus(30 + level, 1 << 18), level)
        cases.append((f"L{level}", PRef.tokenize_host(payload, 0).tape,
                      payload, b""))
    return cases


@pytest.mark.parametrize("case", range(7))
def test_pass_count_is_log2_of_deepest_chain(case):
    """tbz's pass count (the plain loop's: 1 + the first pass that moves
    nothing) equals 1 + ceil(log2 Dmax), Dmax the most hops from any byte
    to its root, found by walking the parents in numpy; the kernel derives
    its count from the same identity. Three adversarial tapes and the
    level-0/1/6/9 tapes."""
    name, tape, inp, win = _count_cases()[case]
    _, _, passes = PR.resolve_device(tape, inp, win, device="cpu",
                                     collect_stats=True)
    ol, di, _, n, _, _, cap = padded_args(tape, inp, win)
    dmax = deepest_chain(ol, di, n, cap)
    assert passes == 1 + math.ceil(math.log2(max(dmax, 1))), (name, dmax)
