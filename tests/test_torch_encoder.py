"""The port's encoder against tbz's: the new native bindings, bitwriter,
lz77, huffman_encode and deflate_encode give tbz's bytes (tolerance 0:
a lossless codec) at levels 0-9, raw/zlib/gzip, with a preset
dictionary, gzip header fields and the segment-parallel path; stdlib
zlib decodes every output; and the port's size is at most libz's on
test_encoder.py's corpora, held to zlib itself (tbz's size is no
oracle: its fast/heavy pick is not checked against the guard again).
Both sides run on the host, so no XLA executable is compiled."""

import gzip
import zlib

import numpy as np
import pytest

from tbz import bitwriter as TBW, deflate_encode as TDE
from tbz import huffman_encode as THE, lz77 as TLZ
from tbz.native import loader as TL
from tbz_torch import api as PA, bitwriter as PBW, deflate_encode as PDE
from tbz_torch import huffman_encode as PHE, lz77 as PLZ
from tbz_torch.native import loader as PL

from test_encoder import _get_size_corpora
from torch_util import corpus

WBITS = {"raw": -15, "zlib": 15, "gzip": 31}
DATA = corpus(41, 100_000)     # past deflate_encode._FAST_MIN (64 KB)


def _codebooks(ol, di, li):
    """A dynamic block's (reversed) codebooks for pack_tokens."""
    from tbz import constants as C
    m = di == 0
    lsym, _, _ = TLZ.length_to_symbol(ol[~m])
    dsym, _, _ = TLZ.dist_to_symbol(di[~m])
    lf = np.bincount(li[m], minlength=288) + np.bincount(lsym, minlength=288)
    lf[256] += 1
    df = np.bincount(dsym, minlength=30)
    ll = THE.package_merge_lengths(lf, 15)
    dl = THE.package_merge_lengths(df, 15)
    lc, lla = THE.codes_from_lengths(ll)
    dc, dla = THE.codes_from_lengths(dl)
    lcr = C.bit_reverse_array(lc.astype(np.int64), np.maximum(lla, 1))
    dcr = C.bit_reverse_array(dc[:30].astype(np.int64),
                              np.maximum(dla[:30], 1))
    return lcr, lla, dcr, dla[:30]


def _stream_tokens(mod, payload: bytes, max_out: int):
    st = mod.new_stream_state()
    res, susp = mod.tokenize_stream(st, payload, 0, 0, 0, max_out)
    t = res.tape
    return (t.out_len.tolist(), t.dist.tolist(), t.root_val.tolist(),
            t.total_out, res.end_bit, res.finished, susp)


def _binding(name: str, mod):
    data = corpus(42, 30_000)
    body = zlib.compress(data, 6)[2:-4]
    ol, di, li = TL.lz77_match(data, 6)
    if name == "package_merge":
        rng = np.random.default_rng(1)
        f = rng.integers(0, 1000, 286) * (rng.random(286) < 0.7)
        return mod.package_merge(f, 15).tolist()
    if name == "plan_blocks":
        return mod.plan_blocks(ol, di, li, 512)
    if name == "tokenize_stream":
        return [_stream_tokens(mod, body, m) for m in (0, 1000, 7)]
    if name == "resolve":
        tape = mod.tokenize(body).tape
        return mod.resolve(tape, body, b"")
    if name == "inflate_pair":
        other = zlib.compress(data[::-1], 9)[2:-4]
        return mod.inflate_pair(body, other, len(data), len(data))
    if name == "inflate_into":
        out = bytearray(len(data) + 64)
        n, end_bit, fin = mod.inflate_into(body, out)
        return n, end_bit, fin, bytes(out[:n])
    if name == "pack_tokens":
        lcr, lla, dcr, dla = _codebooks(ol, di, li)
        return mod.pack_tokens(ol, di, li, lcr, lla, dcr, dla, True, 5, 3)
    if name == "lz77_match":
        return [a.tolist() for a in mod.lz77_match(data, 3)]
    if name == "lz77_match_optimal":
        return [a.tolist() for a in mod.lz77_match_optimal(
            data, 32, 1, 48, sparse=True)] + [
            a.tolist() for a in mod.lz77_match_optimal(data, 160, 2, 258)]
    raise AssertionError(name)


BINDINGS = ("package_merge", "plan_blocks", "tokenize_stream", "resolve",
            "inflate_pair", "inflate_into", "pack_tokens", "lz77_match",
            "lz77_match_optimal")


@pytest.mark.parametrize("name", BINDINGS)
def test_loader_binding_matches_tbz(name):
    assert PL.available() and TL.available()
    assert _binding(name, PL) == _binding(name, TL)


def test_encode_size_limit_matches_tbz():
    class Big:
        def __len__(self):
            return 0x80000000
    for mod in (PL, TL):
        mod._check_encode_size(b"x" * 10)
        with pytest.raises(ValueError, match="2GiB"):
            mod._check_encode_size(Big())


def test_bitwriter_matches_tbz():
    rng = np.random.default_rng(3)
    ws = [PBW.BitWriter(), TBW.BitWriter()]
    for _ in range(3000):
        op = int(rng.integers(5))
        n = int(rng.integers(1, 17))
        v = int(rng.integers(0, 1 << 16))
        for w in ws:
            if op == 0:
                w.bits(v, n)
            elif op == 1:
                w.huff(v, n)
            elif op == 2:
                w.align()
            elif op == 3:
                w.raw_bytes(bytes([v & 255, n]))
            assert w.bit_length() >= 0
    assert ws[0].bytes() == ws[1].bytes()
    assert ws[0].bit_length() == ws[1].bit_length()


@pytest.mark.parametrize("lazy", [False, True])
def test_lz77_matches_tbz(lazy):
    data = corpus(43, 20_000)
    got = PLZ.match_greedy_numpy(data, lazy=lazy)
    want = TLZ.match_greedy_numpy(data, lazy=lazy)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    lens = np.arange(3, 259)
    dists = np.arange(1, 32769)
    for g, w in zip(PLZ.length_to_symbol(lens) + PLZ.dist_to_symbol(dists),
                    TLZ.length_to_symbol(lens) + TLZ.dist_to_symbol(dists)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("native", [True, False])
def test_huffman_encode_matches_tbz(native, monkeypatch):
    if not native:
        monkeypatch.setattr(PL, "available", lambda: False)
        monkeypatch.setattr(TL, "available", lambda: False)
    rng = np.random.default_rng(4)
    for n, limit in ((286, 15), (30, 15), (19, 7), (2, 15), (1, 15)):
        f = rng.integers(0, 5000, n) * (rng.random(n) < 0.6)
        f[0] = max(f[0], 1)
        got = PHE.package_merge_lengths(f, limit)
        np.testing.assert_array_equal(got, THE.package_merge_lengths(f,
                                                                     limit))
        for g, w in zip(PHE.codes_from_lengths(got),
                        THE.codes_from_lengths(got)):
            np.testing.assert_array_equal(g, w)
    lit = PHE.package_merge_lengths(rng.integers(0, 900, 288), 15)
    dist = PHE.package_merge_lengths(rng.integers(0, 90, 30), 15)
    lit[200:250] = 0
    assert PHE.encode_code_lengths(lit) == THE.encode_code_lengths(lit)
    got = PHE.build_dynamic_header(lit, dist)
    want = THE.build_dynamic_header(lit, dist)
    for g, w in zip(got, want):
        if isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def _decoded(payload: bytes, fmt: str, zdict: bytes = b"") -> bytes:
    if zdict:
        return zlib.decompressobj(WBITS[fmt], zdict=zdict).decompress(payload)
    return zlib.decompressobj(WBITS[fmt]).decompress(payload)


@pytest.mark.parametrize("fmt", ["raw", "zlib", "gzip"])
@pytest.mark.parametrize("level", range(10))
def test_compress_matches_tbz(fmt, level):
    got = PA.compress(DATA, fmt, level)
    assert got == TDE.compress(DATA, fmt, level)
    assert _decoded(got, fmt) == DATA


@pytest.mark.parametrize("fmt", ["raw", "zlib"])
@pytest.mark.parametrize("level", [1, 6, 9])
def test_compress_with_zdict_matches_tbz(fmt, level):
    zd = corpus(44, 20_000)
    data = zd[5000:15000] + DATA[:70_000]
    got = PA.compress(data, fmt, level, zdict=zd)
    assert got == TDE.compress(data, fmt, level, zdict=zd)
    assert _decoded(got, fmt, zd) == data


@pytest.mark.parametrize("wbits", [9, 12, 14])
def test_compress_reduced_window_matches_tbz(wbits):
    got = PA.compress(DATA, "zlib", 6, wbits=wbits)
    assert got == TDE.compress(DATA, "zlib", 6, wbits=wbits)
    assert zlib.decompressobj(wbits).decompress(got) == DATA


def test_gzip_header_fields_match_tbz():
    kw = dict(mtime=1_700_000_000, name="dir/fé.txt",
              extra=[(b"AB", b"payload"), (b"Zz", b"")])
    got = PA.compress(DATA[:5000], "gzip", 9, **kw)
    assert got == TDE.compress(DATA[:5000], "gzip", 9, **kw)
    assert gzip.decompress(got) == DATA[:5000]
    assert got[3] == 0x04 | 0x08


@pytest.mark.parametrize("level", [1, 6])
def test_parallel_path_matches_tbz(level):
    data = corpus(45, 3 << 20)
    got = PA.compress(data, "gzip", level, threads=4)
    assert got == TDE.compress(data, "gzip", level, threads=4)
    assert gzip.decompress(got) == data
    assert PDE.deflate_raw_parallel(data, level, 2, segment=1 << 20) == \
        TDE.deflate_raw_parallel(data, level, 2, segment=1 << 20)


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_edge_inputs_match_tbz(level):
    for data in (b"", b"a", b"a" * 40, bytes(range(256)), bytes(5000)):
        for final in (True, False):
            got = PDE.deflate_raw(data, level, final=final)
            assert got == TDE.deflate_raw(data, level, final=final)
            assert zlib.decompressobj(-15).decompress(got) == data


@pytest.mark.parametrize("level", [1, 6])
def test_without_native_library_matches_tbz(level, monkeypatch):
    """With no native library both encoders take the numpy matcher, the
    numpy block planner and package-merge and the Python emitter."""
    monkeypatch.setattr(PL, "available", lambda: False)
    monkeypatch.setattr(TL, "available", lambda: False)
    data = corpus(46, 12_000)
    got = PDE.deflate_raw(data, level)
    assert got == TDE.deflate_raw(data, level)
    assert zlib.decompressobj(-15).decompress(got) == data


def test_compress_reads_config_level(monkeypatch):
    from tbz_torch.utils import config
    monkeypatch.setenv("TBZ_TORCH_LEVEL", "9")
    monkeypatch.setattr(config, "_default", None)
    assert config.get_config().level == 9
    assert PA.compress(DATA) == TDE.compress(DATA, "zlib", 9)
    monkeypatch.setattr(config, "_default", config.Config())
    assert PA.compress(DATA) == TDE.compress(DATA, "zlib", 6)


def test_bad_arguments_raise_like_tbz():
    for kw in ({"wbits": 8}, {"wbits": 16}, {"format": "bz2"},
               {"format": "gzip", "zdict": b"d"}):
        with pytest.raises(ValueError):
            PDE.compress(b"abc", **kw)
        with pytest.raises(ValueError):
            TDE.compress(b"abc", **kw)


@pytest.mark.parametrize("name", ["src", "xml", "text", "binrec", "runs",
                                  "rand", "small-src"])
@pytest.mark.parametrize("level", range(1, 10))
def test_size_at_most_libz(name, level):
    """The port's raw stream is no larger than libz's at the same level,
    on each corpus of test_encoder.py (held to zlib itself)."""
    data = _get_size_corpora()[name]
    raw = PDE.deflate_raw(data, level)
    assert zlib.decompressobj(-15).decompress(raw) == data
    libz = len(zlib.compress(data, level)) - 6
    assert len(raw) <= libz, (name, level, len(raw), libz)
