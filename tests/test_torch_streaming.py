"""The port's streaming codec against tbz's: Decompressor over random
splits (every split of a small stream too), max_length, trailing data
and multi-member gzip; error classes against tbz and stdlib zlib;
checkpoint blobs cross-restored between the two packages (native and
Python inflaters); Compressor, sync_flush included, byte-identical.
Outputs are bytes: tolerance 0. Host code on both sides."""

import gzip
import random
import zlib

import pytest

from tbz import errors as TE, streaming as TS
from tbz.native import loader as TL
from tbz_torch import errors as PE, streaming as PS
from tbz_torch.native import loader as PL

from torch_util import corpus, raw_deflate

DATA = corpus(51, 1 << 17)
SMALL = corpus(52, 3000)
ERRS = ((PE.ChecksumError, TE.ChecksumError),
        (PE.TruncatedError, TE.TruncatedError),
        (PE.DeflateError, TE.DeflateError))


def _run(mod, payload, fmt, sizes, max_length=0, **kw):
    """Feed `payload` in pieces of `sizes` (the rest last), then flush;
    returns (pieces, eof, unused_data, members) or the error's class
    index in ERRS."""
    d = mod.Decompressor(fmt, **kw)
    out, pos = [], 0
    try:
        for s in list(sizes) + [len(payload)]:
            out.append(d.decompress(payload[pos:pos + s], max_length))
            pos += s
        while max_length and d.pending_output:
            out.append(d.decompress(b"", max_length))
        out.append(d.flush())
    except Exception as e:
        for i, classes in enumerate(ERRS):
            if isinstance(e, classes):
                return i, type(e).__name__, getattr(e, "code", None)
        raise
    return out, d.eof, d.unused_data, d.members


def both(payload, fmt, sizes, **kw):
    got = _run(PS, payload, fmt, sizes, **kw)
    assert got == _run(TS, payload, fmt, sizes, **kw)
    return got


def _splits(rng, n, hi):
    sizes, left = [], n
    while left > 0:
        s = rng.randint(1, hi)
        sizes.append(min(s, left))
        left -= s
    return sizes[:-1]


@pytest.mark.parametrize("fmt,mk", [
    ("raw", lambda d: raw_deflate(d, 9)),
    ("zlib", lambda d: zlib.compress(d, 6)),
    ("gzip", lambda d: gzip.compress(d, 1)),
    ("auto", lambda d: gzip.compress(d, 9)),
    ("zlib", lambda d: zlib.compress(d, 0)),
])
def test_random_splits_match_tbz(fmt, mk):
    payload = mk(DATA)
    rng = random.Random(fmt)
    for hi in (7, 1234, 65536):
        out = both(payload, fmt, _splits(rng, len(payload), hi))
        assert b"".join(out[0]) == DATA and out[1]


@pytest.mark.parametrize("fmt", ["raw", "zlib", "gzip"])
def test_every_split_of_a_small_stream(fmt):
    payload = {"raw": raw_deflate(SMALL, 6), "zlib": zlib.compress(SMALL),
               "gzip": gzip.compress(SMALL)}[fmt]
    for cut in range(len(payload) + 1):
        out = both(payload, fmt, [cut])
        assert b"".join(out[0]) == SMALL, cut


@pytest.mark.parametrize("max_length", [1, 3, 1000, 12345])
def test_max_length_matches_tbz(max_length):
    payload = zlib.compress(DATA[:40000] if max_length < 10 else DATA, 9)
    out = both(payload, "zlib", _splits(random.Random(max_length),
                                        len(payload), 997),
               max_length=max_length)
    assert all(len(p) <= max_length for p in out[0][:-1])


def test_trailing_data_and_members_match_tbz():
    members = [corpus(60 + i, 9000 + 77 * i) for i in range(4)]
    payload = b"".join(gzip.compress(m) for m in members) + b"NOT GZIP"
    for hi in (1, 50, 4000):
        out = both(payload, "gzip", _splits(random.Random(hi),
                                            len(payload), hi))
        assert b"".join(out[0]) == b"".join(members)
        assert out[2] == b"NOT GZIP" and len(out[3]) == 4
    z = zlib.compress(SMALL) + b"tail bytes"
    out = both(z, "zlib", [5, 100])
    assert out[2] == b"tail bytes"
    d = PS.Decompressor("zlib")
    d.decompress(z[:10], max_length=5)
    assert d.needs_input and d.unconsumed_tail == b""


def test_thousands_of_members_match_tbz():
    payload = b"".join(gzip.compress(b"m%d;" % i) for i in range(2000))
    out = both(payload, "gzip", [])
    assert len(out[3]) == 2000


def test_zdict_matches_tbz():
    zd = DATA[:30000]
    co = zlib.compressobj(9, zlib.DEFLATED, 15, zdict=zd)
    payload = co.compress(DATA[30000:60000]) + co.flush()
    out = both(payload, "zlib", [7] * 40, zdict=zd)
    assert b"".join(out[0]) == DATA[30000:60000]
    raw = raw_deflate(DATA[30000:60000], 9, zd)
    out = both(raw, "raw", [1000], zdict=zd)
    assert b"".join(out[0]) == DATA[30000:60000]


def _corruptions():
    z = zlib.compress(DATA[:50000], 6)
    g = gzip.compress(DATA[:50000], 6)
    flip = bytearray(z)
    flip[-1] ^= 1
    gcrc = bytearray(g)
    gcrc[-6] ^= 0xFF
    gsize = bytearray(g)
    gsize[-2] ^= 1
    body = bytearray(z)
    body[len(z) // 2] ^= 0x55
    zd = corpus(53, 20000)
    far = raw_deflate(zd + DATA[:20000], 9, zd)
    return {
        "adler": (bytes(flip), "zlib", zlib.MAX_WBITS),
        "crc": (bytes(gcrc), "gzip", 31),
        "isize": (bytes(gsize), "gzip", 31),
        "truncated": (z[:len(z) // 2], "zlib", zlib.MAX_WBITS),
        "corrupt body": (bytes(body), "zlib", zlib.MAX_WBITS),
        "block type 3": (b"\x07", "raw", -15),
        "too far": (far, "raw", -15),
        "bad zlib header": (b"\x78\x9d" + z[2:], "zlib", zlib.MAX_WBITS),
        "bad gzip method": (g[:2] + b"\x07" + g[3:], "gzip", 31),
    }


@pytest.mark.parametrize("name", list(_corruptions()))
def test_error_classes_match_tbz_and_zlib(name):
    payload, fmt, wbits = _corruptions()[name]
    with pytest.raises(zlib.error):
        d = zlib.decompressobj(wbits)
        d.decompress(payload)
        if not d.eof:
            raise zlib.error("incomplete or truncated stream")
    for sizes in ([], [1] * 40, [3000]):
        got = both(payload, fmt, sizes)
        assert isinstance(got[0], int), (name, "accepted")


def _checkpointed(writer, reader, payload, fmt, rng, **kw):
    """Decode through `writer`'s Decompressor, restoring each blob it
    takes in `reader` and back again; returns the output."""
    d = writer.Decompressor(fmt, **kw)
    out, pos, mods = [], 0, (writer, reader)
    while pos < len(payload):
        n = rng.randint(1, 7777)
        out.append(d.decompress(payload[pos:pos + n]))
        pos += n
        if rng.random() < 0.5:
            mods = mods[::-1]
            d = mods[0].Decompressor.restore(d.checkpoint())
    out.append(d.flush())
    assert d.eof
    return b"".join(out)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("first", ["tbz", "tbz_torch"])
def test_checkpoints_restore_across_packages(first, native, monkeypatch):
    if not native:
        monkeypatch.setattr(PL, "available", lambda: False)
        monkeypatch.setattr(TL, "available", lambda: False)
    mods = (TS, PS) if first == "tbz" else (PS, TS)
    data = DATA if native else DATA[:30000]
    zd = corpus(54, 5000)
    co = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=zd)
    cases = [("gzip", gzip.compress(data[:9000]) + gzip.compress(data), {}),
             ("zlib", co.compress(data) + co.flush(), {"zdict": zd})]
    for fmt, payload, kw in cases:
        got = _checkpointed(*mods, payload, fmt, random.Random(fmt), **kw)
        assert got == (data[:9000] + data if fmt == "gzip" else data)
    d = mods[0].Decompressor("zlib")
    d.decompress(zlib.compress(data), max_length=20000)
    blob = d.checkpoint()
    assert blob[:5] == b"TBZC\x02"
    kinds = {"_NativeInflater" if native else "IncrementalInflater"}
    assert {PS._ckpt_loads(blob)["inflater"][0]} == kinds
    d2 = mods[1].Decompressor.restore(blob)
    assert d2.decompress(b"") + d2.flush() == data[20000:]


def test_checkpoint_codec_matches_tbz():
    import numpy as np
    obj = {"a": [1, -5, 0x1234567890, True, None, b"xy", "é"],
           "arr": np.arange(12, dtype=np.int16).reshape(3, 4)}
    blob = PS._ckpt_dumps(obj)
    assert blob == TS._ckpt_dumps(obj)
    back = TS._ckpt_loads(blob)
    assert back["a"] == obj["a"]
    np.testing.assert_array_equal(back["arr"], obj["arr"])
    for bad in (b"\x80\x04" + blob[2:], blob[:-3]):
        for mod in (PS, TS):
            with pytest.raises(ValueError):
                mod._ckpt_loads(bad)


@pytest.mark.parametrize("fmt", ["raw", "zlib", "gzip"])
@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_compressor_matches_tbz(fmt, level):
    data = corpus(55, (5 << 20) // 2)
    kw = {"mtime": 77, "name": "x.bin"} if fmt == "gzip" else {}
    if fmt == "zlib" and level == 6:
        kw = {"zdict": data[:4000], "wbits": 12}
    outs = []
    for mod in (PS, TS):
        c = mod.Compressor(fmt, level, **kw)
        parts, pos = [], 0
        r = random.Random(level)
        while pos < len(data):
            n = r.choice((1, 500, 70_000, 1 << 20))
            parts.append(c.compress(data[pos:pos + n]))
            pos += n
            if r.random() < 0.1:
                parts.append(c.sync_flush())
        parts.append(c.flush())
        outs.append(parts)
        with pytest.raises(ValueError):
            c.compress(b"more")
    assert outs[0] == outs[1]
    blob = b"".join(outs[0])
    wbits = {"raw": -15, "zlib": 15, "gzip": 31}[fmt]
    d = zlib.decompressobj(wbits, **({"zdict": kw["zdict"]}
                                     if "zdict" in kw else {}))
    assert d.decompress(blob) == data and d.eof


def test_sync_flush_is_a_zlib_sync_point():
    for mod in (PS, TS):
        c = mod.Compressor("raw", 6)
        head = c.compress(SMALL) + c.sync_flush()
        assert head.endswith(b"\x00\x00\xff\xff")
        assert zlib.decompressobj(-15).decompress(head) == SMALL
    outs = []
    for mod in (PS, TS):
        c = mod.Compressor("zlib", 6)
        outs.append(c.sync_flush() + c.sync_flush() + c.flush())
    assert outs[0] == outs[1] and zlib.decompress(outs[0]) == b""
