"""The device frontend's tiers for streams of 64 KB and more, on the CPU
(the plain kernel versions): tokenize_stream_speculative and
tokenize_stream_batched against tbz's (XLA on the CPU) and the Python
oracle on static-only, stored-mix and multi-block streams, plus the
error cases of tests/test_speculative.py. Tapes, end_bit and finished
exactly equal (tolerance 0)."""

import zlib

import jax
import numpy as np
import pytest

from tbz.ops import batched as TB
from tbz.ops import speculative as TS
from tbz_torch import constants as PC
from tbz_torch import errors as PE
from tbz_torch import reference as PR
from tbz_torch.ops import batched as PB
from tbz_torch.ops import speculative as PS
from tbz_torch.ops import tokenize_device as PT

from torch_util import corpus, raw_deflate


@pytest.fixture(autouse=True, scope="module")
def _release_xla_executables():
    """Free tbz's compiled XLA executables after this module: each holds
    hundreds of memory maps, and the whole suite runs in one process,
    under the kernel's limit of 65530 maps."""
    yield
    jax.clear_caches()


def _same(a, b):
    assert a.end_bit == b.end_bit and a.finished == b.finished
    assert np.array_equal(a.tape.out_len, b.tape.out_len)
    assert np.array_equal(a.tape.dist, b.tape.dist)
    assert np.array_equal(a.tape.root_val, b.tape.root_val)
    assert a.tape.total_out == b.tape.total_out


def _static(data):
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    return co.compress(data) + co.flush()


def _stored_mix():
    co = zlib.compressobj(9, zlib.DEFLATED, -15)
    p1 = co.compress(corpus(93, 12000)) + co.flush(zlib.Z_FULL_FLUSH)
    co0 = zlib.compressobj(0, zlib.DEFLATED, -15)
    return p1 + co0.compress(b"STORED" * 3000) + co0.flush()


def _multiblock():
    co = zlib.compressobj(9, zlib.DEFLATED, -15)
    out = b""
    for seed in (91, 92, 94):
        out += co.compress(corpus(seed, 6000)) + co.flush(zlib.Z_FULL_FLUSH)
    return out + co.flush()


STREAMS = {
    "static": lambda: _static(corpus(9, 40000)),
    "stored_mix": _stored_mix,
    "multiblock": _multiblock,
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_speculative_matches_tbz(name):
    payload = STREAMS[name]()
    got, st = PS.tokenize_stream_speculative(payload, collect_stats=True,
                                             device="cpu")
    want, wst = TS.tokenize_stream_speculative(payload, collect_stats=True)
    _same(got, want)
    _same(got, PR.tokenize_host(payload, 0))
    assert st == wst


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_batched_matches_tbz(name):
    payload = STREAMS[name]()
    got = PB.tokenize_stream_batched(payload, device="cpu")
    _same(got, TB.tokenize_stream_batched(payload))
    _same(got, PR.tokenize_host(payload, 0))


def test_static_block_lanes_sync():
    """One static block, many lanes: exact, and lanes resynchronize."""
    payload = _static(corpus(8, 60000))
    tape, end_bit, stats = PS.tokenize_block_speculative(
        payload, 3, PC.FIXED_LITLEN_LENGTHS, PC.FIXED_DIST_LENGTHS,
        device="cpu")
    want = PR.tokenize_host(payload)
    assert np.array_equal(tape.out_len, want.tape.out_len)
    assert end_bit == want.blocks[0].end_bit
    assert stats["lanes"] > 4 and stats["sync_rate"] > 0.3


def test_errors():
    payload = zlib.compress(corpus(94, 30000), 9)[2:-4]
    with pytest.raises(PE.TruncatedError):
        PS.tokenize_stream_speculative(payload[:-40], device="cpu")
    with pytest.raises(PE.DeflateError):
        PS.tokenize_stream_speculative(b"\x07\x00", device="cpu")
    bad = bytearray(_static(corpus(10, 20000)))
    bad[len(bad) // 2] ^= 0x10
    # a flipped bit mid-block: the speculative tier checks distances
    # after the block, so its error may differ from the oracle's; the
    # port raises what tbz raises
    cls = {}
    for name, fn in (("port", lambda p: PS.tokenize_stream_speculative(
            p, device="cpu")), ("tbz", TS.tokenize_stream_speculative)):
        try:
            fn(bytes(bad))
            cls[name] = "ok"
        except Exception as e:  # tbz's and the port's error classes
            cls[name] = (type(e).__name__, getattr(e, "code", None))
    assert cls["port"] == cls["tbz"] != "ok"


def test_tokenize_auto_routes_by_size(monkeypatch):
    small = raw_deflate(corpus(95, 1000), 9)
    big = _static(corpus(96, 1 << 18))
    assert len(big) >= PT.SPECULATIVE_MIN_BYTES > len(small)
    seen = []
    monkeypatch.setattr(PB, "tokenize_stream_batched",
                        lambda d, w, device=None: seen.append("batched")
                        or PS.tokenize_stream_speculative(d, w,
                                                          device=device))
    for payload in (small, big):
        r = PT.tokenize_auto(payload, device="cpu")
        _same(r, PR.tokenize_host(payload, 0))
    assert seen == ["batched"]


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_python_stitcher_without_native(monkeypatch, name):
    """Where the native library did not build, the stitcher decodes its
    gaps and tails with the reference's Python decoder, as tbz's does,
    and the batched tier hands every stream to the speculative one."""
    from tbz_torch.native import loader as PL
    payload = STREAMS[name]()
    want = PR.tokenize_host(payload, 0)
    monkeypatch.setattr(PL, "available", lambda: False)
    _same(PS.tokenize_stream_speculative(payload, device="cpu"), want)
    _same(PB.tokenize_stream_batched(payload, device="cpu"), want)
