"""The data: made from the seed alone, exact to the published sizes, and
written into payloads that stdlib decodes, each by the module of its
container format."""

import gzip
import hashlib
import json
import os
import zlib

import pytest

import cells
import corpus
import reference
from conftest import BENCH, cpu_scale

FORMATS = sorted(os.path.splitext(f)[0]
                 for f in os.listdir(os.path.join(BENCH, "formats"))
                 if f.endswith(".py"))


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
        assert p.endswith(cells.format_module("gzip").checks(d))
    # one file at its full published size
    n = dict(cfg["files"])["xml"]
    d = corpus.make_file(99, 10, n)
    assert len(d) == n
    assert gzip.decompress(cells.format_module("gzip").write(d, 6)) == d


@pytest.mark.parametrize("fmt", ["gzip", "zlib"])
def test_broken_trailer_is_refused_by_stdlib(fmt):
    d = corpus.make_file(5, 0, 100000)
    mod = cells.format_module(fmt)
    p = mod.write(d, 6)
    bad = mod.probe(p)
    assert len(bad) == len(p) and bad != p
    decode = gzip.decompress if fmt == "gzip" else zlib.decompress
    with pytest.raises((OSError, zlib.error)):
        decode(bad)
    ref = reference.Reference(mod, [d])
    assert ref.expect(0, p) == d
    assert ref.expect(0, bad) is reference.CHECKSUM_ERROR


@pytest.mark.parametrize("fmt", FORMATS)
def test_a_format_module_writes_checks_and_probes(fmt):
    """Every formats/<format>.py: its payload's checks hold the data's
    values and no other data's, and its probe breaks one of them."""
    mod = cells.format_module(fmt)
    a, b = corpus.make_file(3, 0, 70000), corpus.make_file(3, 1, 70000)
    p = mod.write(a, 6)
    assert p == mod.write(a, 6) and p != mod.write(b, 6)
    assert mod.holds(p, mod.checks(a))
    assert not mod.holds(p, mod.checks(b))
    bad = mod.probe(p)
    assert len(bad) == len(p) and bad != p
    assert not mod.holds(bad, mod.checks(a))


def _digest(items):
    h = hashlib.sha256()
    for b in items:
        h.update(len(b).to_bytes(8, "little"))
        h.update(b)
    return h.hexdigest()


# sha256 of each configuration's datas and of its payloads (each file's
# length, 8 bytes little-endian, then its bytes, in the configuration's
# order) at its CPU scale, taken from the harness as it was before the
# container formats moved into formats/
PINNED = {
    ("silesia_gzip6", 2**31 + 11): (
        "1b5af1a42d334e09a78cb7282a9412252f1a9ea788c0401e3066f4a6b66aa7e5",
        "6bdf117a1a4e4fdc7b293fd746292e46a93dd64370a45192db7c2938694a849c"),
    ("silesia_gzip6", 2**40 + 3): (
        "7202aff93897c2885477393fd53e02cb94425259dff2419ff383a90a295099ab",
        "ace5206b82b7d7ff960e969e5fec523ff8c45efca81dea20a019865f3f465007"),
    ("canterbury_zlib6", 2**31 + 11): (
        "64661a8372d4a56c08d921a12f201375477afda3c19de6298082654a36ecf6db",
        "ebdae3985d49d6383a107ce30d081cda7470641eccb84f8e6ce1d0b60527e8c2"),
    ("canterbury_zlib6", 2**40 + 3): (
        "5271a301e8e066828b60d3b7ead6365ab6540d5e180c55888201c0a9334b7963",
        "5cc34ea59b5bae7fb0b70a151e0a88b81e9522873d0e1c7f917943682be40abc"),
}


@pytest.mark.parametrize("name,seed", sorted(PINNED))
def test_datas_and_payloads_are_pinned(name, seed):
    cfg = _config(name)
    datas, payloads = corpus.make_config(cfg, seed, scale=cpu_scale(cfg))
    assert (_digest(datas), _digest(payloads)) == PINNED[name, seed]
