"""The data: made from the seed alone, exact to the published sizes, and
compressed into members that stdlib decodes."""

import gzip
import json
import os
import zlib

import pytest

import corpus
import reference
from conftest import BENCH


def _config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("size", [1, 2, 15, 16, 159, 4096, 65537,
                                  1 << 20, 3721])
def test_exact_size_and_deterministic(size):
    seed = 2**31 + 7
    a = corpus.make_file(seed, 3, size)
    assert len(a) == size
    assert a == corpus.make_file(seed, 3, size)


def test_seed_and_index_change_the_bytes():
    a = corpus.make_file(1, 0, 1 << 16)
    assert a != corpus.make_file(2, 0, 1 << 16)
    assert a != corpus.make_file(1, 1, 1 << 16)
    # a seed past 64 bits is taken modulo 2^64, and a negative one too
    assert corpus.make_file(2**64 + 5, 0, 4096) == corpus.make_file(5, 0, 4096)
    assert len(corpus.make_file(-3, 0, 4096)) == 4096


def test_the_mix_holds_every_kind():
    d = corpus.make_file(11, 0, 1 << 18)
    assert b" deflate " in d or b"deflate\n" in d      # text lines
    assert (0x00C0FFEE).to_bytes(4, "little") in d      # records
    assert b"\n" in d and any(bytes([b]) * 64 in d for b in range(256))


def test_canterbury_at_its_published_sizes():
    cfg = _config("canterbury_zlib6")
    datas, payloads = corpus.make_config(cfg, 2**33 + 1)
    assert [len(d) for d in datas] == [n for _, n in cfg["files"]]
    for d, p in zip(datas, payloads):
        assert zlib.decompress(p) == d
    big = sorted(n for (_, n), p in zip(cfg["files"], payloads)
                 if len(p) - 6 >= 65536)
    assert big == [426754, 481861, 513216, 1029744]   # the fused route's
    again, _ = corpus.make_config(cfg, 2**33 + 1, threads=2)
    assert again == datas


def test_silesia_sizes_and_gzip_members():
    cfg = _config("silesia_gzip6")
    datas, payloads = corpus.make_config(cfg, 99, scale=0.01)
    assert [len(d) for d in datas] == [int(n * 0.01)
                                       for _, n in cfg["files"]]
    for d, p in zip(datas, payloads):
        assert gzip.decompress(p) == d
        assert p[:10] == bytes([0x1F, 0x8B, 8, 0, 0, 0, 0, 0, 0, 3])
        assert p.endswith(reference.checksum("gzip", d))
    # one file at its full published size
    n = dict(cfg["files"])["xml"]
    d = corpus.make_file(99, 10, n)
    assert len(d) == n
    assert gzip.decompress(corpus.compress(d, "gzip", 6)) == d


@pytest.mark.parametrize("fmt", ["gzip", "zlib"])
def test_broken_trailer_is_refused_by_stdlib(fmt):
    d = corpus.make_file(5, 0, 100000)
    p = corpus.compress(d, fmt, 6)
    bad = reference.break_trailer(fmt, p)
    assert len(bad) == len(p) and bad != p
    decode = gzip.decompress if fmt == "gzip" else zlib.decompress
    with pytest.raises((OSError, zlib.error)):
        decode(bad)
    ref = reference.Reference(fmt, [d])
    assert ref.expect(0, p) == d
    assert ref.expect(0, bad) is reference.CHECKSUM_ERROR
