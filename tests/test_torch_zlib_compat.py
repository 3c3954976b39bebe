"""tbz_torch.zlib_compat against stdlib zlib first and tbz.zlib_compat
wherever tbz agrees with stdlib: every wbits form, the decompressobj
loop of stdlib's docs at several max_length values, zdict, copy(),
unused_data and eof, compress-side bytes, the combines past 2^29 bytes,
and the window check that tbz lacks. The port decodes on the CPU device
(the kernels' plain versions); tbz's one-shot decompress runs its
default host backend. Bytes and error classes: tolerance 0."""

import gzip
import zlib

import numpy as np
import pytest
import torch

import tbz.zlib_compat as TZ
import tbz_torch.zlib_compat as PZ
from tbz_torch import api as PA

from torch_util import corpus

DATA = corpus(61, 100 << 10)   # the fused decode (bodies of 64 KB and more)
SMALL = corpus(62, 20 << 10)   # the declined route


def _co(data, level, wbits, zdict=None):
    co = (zlib.compressobj(level, zlib.DEFLATED, wbits) if zdict is None
          else zlib.compressobj(level, zlib.DEFLATED, wbits, 8, 0, zdict))
    return co.compress(data) + co.flush()


# (wbits to decode with, wbits the stream was made with)
WBITS = [(15, 15), (0, 15), (12, 12), (9, 9), (0, 10), (-15, -15),
         (-9, -9), (31, 31), (25, 25), (47, 15), (47, 31), (41, 9),
         (44, 28)]


@pytest.mark.parametrize("data", [DATA, SMALL], ids=["100K", "20K"])
@pytest.mark.parametrize("wbits,made", WBITS,
                         ids=[f"{w}<-{m}" for w, m in WBITS])
def test_every_wbits_form(wbits, made, data):
    payload = _co(data, 6, made)
    want = zlib.decompress(payload, wbits)
    assert want == data
    assert PZ.decompress(payload, wbits, device="cpu") == want
    assert TZ.decompress(payload, wbits) == want
    assert PZ.decompress(payload, wbits, backend="host") == want


def test_default_device_is_cuda_and_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(PA, "_decode_body", lambda *a, **k: ran.append(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        PZ.decompress(zlib.compress(b"x" * 1000))
    assert not ran


@pytest.mark.parametrize("wbits", [9, 12, 14, 41, 44])
def test_window_larger_than_wbits_raises_like_stdlib(wbits):
    """A zlib header whose window (CINFO 7: 32 KB) exceeds wbits."""
    payload = zlib.compress(SMALL, 6)
    with pytest.raises(zlib.error, match="invalid window size") as std:
        zlib.decompress(payload, wbits)
    with pytest.raises(PZ.error) as mine:
        PZ.decompress(payload, wbits, device="cpu")
    assert str(mine.value) == str(std.value)
    # decompressobj: as soon as the header's two bytes are in
    for first in (1, 2, len(payload)):
        d = PZ.decompressobj(wbits)
        with pytest.raises(PZ.error, match="invalid window size"):
            d.decompress(payload[:first])
            d.decompress(payload[first:first + 1])
        s = zlib.decompressobj(wbits)
        with pytest.raises(zlib.error, match="invalid window size"):
            s.decompress(payload[:first])
            s.decompress(payload[first:first + 1])


def test_window_check_leaves_other_headers_to_the_decoder():
    """A gzip stream under 41..47, a raw stream, and a zlib header that
    fails its FCHECK are not window errors."""
    assert PZ.decompress(gzip.compress(SMALL), 41, device="cpu") == SMALL
    raw = _co(SMALL, 6, -15)
    assert PZ.decompress(raw, -9, backend="host") == SMALL
    bad = bytes([0x78, 0x9D]) + zlib.compress(SMALL)[2:]
    for call in (lambda: zlib.decompress(bad, 9),
                 lambda: PZ.decompress(bad, 9, device="cpu")):
        with pytest.raises(zlib.error) as e:
            call()
        assert "invalid window size" not in str(e.value)


def test_tbz_drops_the_window_of_wbits():
    """The known departure of the reference (ROADMAP §C): tbz decodes
    a CINFO-7 stream under wbits 9 where stdlib and the port raise."""
    payload = zlib.compress(SMALL, 6)
    assert TZ.decompress(payload, 9) == SMALL
    d = TZ.decompressobj(9)
    assert d.decompress(payload) + d.flush() == SMALL


def _loop(mod, payload, max_length, wbits=15):
    """stdlib's documented bounded loop: re-feed unconsumed_tail."""
    d = mod.decompressobj(wbits)
    out = d.decompress(payload, max_length)
    rounds = 0
    while d.unconsumed_tail and not d.eof:
        out += d.decompress(d.unconsumed_tail, max_length)
        rounds += 1
        assert rounds < 200000
    # read before flush(): stdlib's flush() feeds an unconsumed_tail
    # left at the end of the stream to unused_data once more
    unused = d.unused_data
    return out + d.flush(), d.eof, unused


@pytest.mark.parametrize("max_length", [7, 1000, 65536])
@pytest.mark.parametrize("fmt", ["zlib", "gzip", "raw"])
def test_decompressobj_unconsumed_tail_loop(fmt, max_length):
    data = SMALL if max_length > 7 else SMALL[:4000]
    wbits = {"zlib": 15, "gzip": 31, "raw": -15}[fmt]
    payload = _co(data, 6, wbits) + b"TRAILING"
    want = _loop(zlib, payload, max_length, wbits)
    assert want[0] == data and want[1]
    assert _loop(PZ, payload, max_length, wbits) == want
    assert _loop(TZ, payload, max_length, wbits) == want


def test_decompressobj_chunks_zdict_copy_unused_eof():
    hist = b"the quick brown fox jumps over the lazy dog " * 20
    data = hist[-500:] + SMALL
    payload = _co(data, 9, 15, hist) + b"tail"
    results = []
    for mod in (zlib, PZ, TZ):
        d = mod.decompressobj(15, hist)
        out = b""
        for i in range(0, 2800, 700):
            out += d.decompress(payload[i:i + 700])
        fork = d.copy()
        rest = payload[2800:]
        a = out + d.decompress(rest) + d.flush()
        b = out + fork.decompress(rest) + fork.flush()
        results.append((a, b, d.eof, fork.eof, d.unused_data,
                        fork.unused_data))
    assert results[0][0] == data and results[0][4] == b"tail"
    assert results[1] == results[0] == results[2]


def test_compress_side_equals_tbz_and_reads_in_stdlib():
    for wbits in (15, 12, 9, -15, -9, 31):
        for level in (0, 1, 6, 9, -1):
            mine = PZ.compress(SMALL, level, wbits)
            assert mine == TZ.compress(SMALL, level, wbits)
            assert zlib.decompress(mine, wbits) == SMALL
        co, tco = PZ.compressobj(6, 8, wbits), TZ.compressobj(6, 8, wbits)
        parts, tparts = [], []
        for i in range(0, len(SMALL), 5000):
            parts.append(co.compress(SMALL[i:i + 5000]))
            tparts.append(tco.compress(SMALL[i:i + 5000]))
            if i == 5000:
                parts.append(co.flush(PZ.Z_SYNC_FLUSH))
                tparts.append(tco.flush(TZ.Z_SYNC_FLUSH))
                fork = co.copy()
        parts.append(co.flush())
        tparts.append(tco.flush())
        assert b"".join(parts) == b"".join(tparts)
        assert zlib.decompress(b"".join(parts), wbits) == SMALL
        tail = fork.compress(SMALL[10000:]) + fork.flush()
        head = b"".join(parts[:3])
        assert zlib.decompress(head + tail, wbits) == SMALL
    with pytest.raises(PZ.error):
        PZ.compress(b"x", 6, 0)
    with pytest.raises(PZ.error):
        PZ.compressobj(10)
    co = PZ.compressobj()
    co.flush()
    with pytest.raises(PZ.error):
        co.compress(b"more")


def test_constants_and_error_are_stdlib_s():
    assert PZ.error is zlib.error
    names = [n for n in dir(TZ) if n.isupper()]
    assert names and all(getattr(PZ, n) == getattr(TZ, n) for n in names)
    for n in ("Z_BEST_SPEED", "MAX_WBITS", "DEFLATED", "Z_SYNC_FLUSH",
              "Z_FINISH", "ZLIB_VERSION"):
        assert getattr(PZ, n) == getattr(zlib, n)


def _crc_adler_of_pattern(block: bytes, n: int):
    """zlib's CRC-32 and Adler-32 of `block` repeated to n bytes, in
    pieces (no n-byte buffer)."""
    crc, adler, left = 0, 1, n
    while left:
        piece = block[:min(left, len(block))]
        crc, adler = zlib.crc32(piece, crc), zlib.adler32(piece, adler)
        left -= len(piece)
    return crc, adler


@pytest.mark.parametrize("len2", [0, 1, 5000, (1 << 29) + 5])
def test_combines_against_zlib(len2):
    a = corpus(63, 3000)
    block = np.random.default_rng(64).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    c2, a2 = _crc_adler_of_pattern(block, len2)
    crc, adler = zlib.crc32(a), zlib.adler32(a)
    left = len2
    while left:
        piece = block[:min(left, len(block))]
        crc, adler = zlib.crc32(piece, crc), zlib.adler32(piece, adler)
        left -= len(piece)
    assert PZ.crc32_combine(zlib.crc32(a), c2, len2) == crc
    assert PZ.adler32_combine(zlib.adler32(a), a2, len2) == adler
    assert TZ.crc32_combine(zlib.crc32(a), c2, len2) == crc
    assert TZ.adler32_combine(zlib.adler32(a), a2, len2) == adler
    assert PZ.crc32(a) == zlib.crc32(a) and PZ.adler32(a, 7) == \
        zlib.adler32(a, 7)
