"""tbz_torch.index.SeekIndex against tbz.index.SeekIndex and slices of
the data: random windows over raw, zlib, gzip and multi-member gzip
streams, index blobs serialized by one package loaded and read by the
other (both ways, byte-identical blobs), and the error classes. Host
code on both sides. Bytes: tolerance 0."""

import gzip
import zlib

import numpy as np
import pytest

from tbz import errors as TE
from tbz.index import SeekIndex as TIndex
from tbz_torch import errors as PE
from tbz_torch.index import SeekIndex as PIndex

from torch_util import corpus, raw_deflate

DATA = corpus(81, 3 << 19)   # 1.5 MiB


def _payload(fmt):
    if fmt == "raw":
        return raw_deflate(DATA, 6), DATA
    if fmt == "zlib":
        return zlib.compress(DATA, 6), DATA
    if fmt == "gzip":
        return gzip.compress(DATA, 6), DATA
    a, b, c = DATA[:1 << 19], DATA[1 << 19:5 << 18], DATA[5 << 18:]
    return (gzip.compress(a, 6) + gzip.compress(b, 9)
            + gzip.compress(c, 1)), DATA


def _windows(seed, n):
    rng = np.random.default_rng(seed)
    out = [(int(rng.integers(0, len(DATA))), int(rng.integers(1, 200000)))
           for _ in range(n)]
    return out + [(0, 16), (len(DATA) - 3, 50), (len(DATA) + 1, 5),
                  (5, 0), (1 << 19, 1 << 19)]


@pytest.mark.parametrize("fmt", ["raw", "zlib", "gzip", "members"])
def test_random_windows_and_blobs_across_packages(fmt):
    payload, data = _payload(fmt)
    name = "gzip" if fmt == "members" else fmt
    mine = PIndex.build(payload, name, every=1 << 18)
    theirs = TIndex.build(payload, name, every=1 << 18)
    assert mine.total_out == theirs.total_out == len(data)
    assert mine.format == theirs.format == name
    blob = mine.serialize()
    assert blob == theirs.serialize()
    # each package reads through the other's index
    cross = (PIndex.load(theirs.serialize()), TIndex.load(blob))
    for start, size in _windows(7, 12):
        want = data[start:start + size]
        assert mine.read(payload, start, size) == want
        for idx in cross:
            assert idx.read(payload, start, size) == want


def test_member_boundaries_and_auto_format():
    payload, data = _payload("members")
    idx = PIndex.load(PIndex.build(payload, every=1 << 16).serialize())
    assert idx.format == "gzip"
    for edge in (1 << 19, 5 << 18):
        assert idx.read(payload, edge - 100, 200) == data[edge - 100:
                                                          edge + 100]
    assert len(idx.points) == len(TIndex.build(payload,
                                               every=1 << 16).points)


def test_error_classes_match_tbz():
    bad = bytearray(zlib.compress(DATA[:200000], 6))
    bad[len(bad) // 2] ^= 0xFF
    errs = []
    for cls in (PIndex, TIndex):
        with pytest.raises(Exception) as e:
            cls.build(bytes(bad), "zlib", every=1 << 16)
        errs.append(type(e.value).__name__)
    assert errs[0] == errs[1]
    with pytest.raises(PE.DeflateError):
        PIndex.load(b"not an index")
    blob = PIndex.build(gzip.compress(DATA[:300000]), every=1 << 16
                        ).serialize()
    for cls, err in ((PIndex, PE.DeflateError), (TIndex, TE.DeflateError)):
        with pytest.raises(err, match="truncated"):
            cls.load(blob[:-10])
