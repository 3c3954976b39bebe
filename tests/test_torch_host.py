"""tbz_torch.parallel.host against tbz.parallel.host and stdlib zlib:
decompress_many over mixed formats on the CPU device (the kernels'
plain versions, each stream through api.decompress), with out= (the
native host inflate), with return_errors, and compress_many; the
default device raises without a card. Also the launch counters and the
stage timers under many threads. Bytes and error classes: tolerance
0."""

import gzip
import sys
import threading
import zlib

import pytest
import torch

from tbz import errors as TE
from tbz.parallel import host as TH
from tbz_torch import _cuda
from tbz_torch import api as PA
from tbz_torch import errors as PE
from tbz_torch.parallel import host as PH
from tbz_torch.utils import profiling

from torch_util import corpus, mixed_blocks, raw_deflate

DATAS = [corpus(90 + i, n) for i, n in
         enumerate((100 << 10, 20 << 10, 90 << 10, 3000, 0, 70 << 10))]


def _payloads():
    d = DATAS
    return [gzip.compress(d[0], 6), zlib.compress(d[1], 9),
            raw_deflate(d[2], 1),
            gzip.compress(d[3][:1000]) + gzip.compress(d[3][1000:]),
            zlib.compress(d[4]), gzip.compress(d[5], 1)]


FORMATS = ["auto", "auto", "raw", "auto", "auto", "gzip"]


def test_decompress_many_on_the_cpu_device_equals_tbz_and_zlib():
    payloads = _payloads()
    # per-stream auto-detect: the raw stream needs format="raw" alone
    auto = [p for p, f in zip(payloads, FORMATS) if f != "raw"]
    want = [d for d, f in zip(DATAS, FORMATS) if f != "raw"]
    mine = PH.decompress_many(auto, device="cpu", threads=4)
    assert mine == want == TH.decompress_many(auto)
    assert PH.decompress_many([payloads[2]], "raw", device="cpu") == \
        [DATAS[2]]
    assert PH.decompress_many(auto, backend="host") == want
    assert PH.decompress_many([mixed_blocks(5)], "raw", device="cpu") == \
        [zlib.decompress(mixed_blocks(5), -15)]
    assert PH.decompress_many([], device="cpu") == []


def test_decompress_many_into_buffers():
    payloads = _payloads()
    outs = [bytearray(len(d) + 64) for d in DATAS]
    got = PH.decompress_many(payloads[:2] + payloads[3:], out=outs[:2]
                             + outs[3:], threads=3)
    theirs = TH.decompress_many(payloads[:2] + payloads[3:], out=[
        bytearray(len(d) + 64) for d in DATAS[:2] + DATAS[3:]])
    for (buf, n), (tbuf, tn), d in zip(got, theirs, DATAS[:2] + DATAS[3:]):
        assert n == tn == len(d) and bytes(buf[:n]) == bytes(tbuf[:n]) == d
    with pytest.raises(ValueError):
        PH.decompress_many(payloads, out=outs[:2])


def _corrupt(payload, at):
    b = bytearray(payload)
    b[at] ^= 0xFF
    return bytes(b)


def test_return_errors_gives_tbz_s_classes_at_their_index():
    payloads = _payloads()
    bad = list(payloads)
    bad[0] = _corrupt(payloads[0], -6)          # gzip CRC-32
    bad[1] = _corrupt(payloads[1], -1)          # zlib Adler-32
    bad[3] = payloads[3][:-20]                  # truncated member
    bad = [p for p, f in zip(bad, FORMATS) if f != "raw"]
    mine = PH.decompress_many(bad, device="cpu", return_errors=True)
    theirs = TH.decompress_many(bad, return_errors=True)
    names = [type(r).__name__ if isinstance(r, Exception) else r
             for r in mine]
    assert names == [type(r).__name__ if isinstance(r, Exception) else r
                     for r in theirs]
    assert names[:3] == ["ChecksumError", "ChecksumError", "TruncatedError"]
    assert isinstance(mine[0], PE.ChecksumError)
    assert isinstance(theirs[0], TE.ChecksumError)
    assert mine[3:] == [DATAS[4], DATAS[5]]
    with pytest.raises(PE.ChecksumError):
        PH.decompress_many(bad, device="cpu")
    outs = [bytearray(len(d) + 64) for d in DATAS]
    got = PH.decompress_many(bad, out=outs[:2] + outs[3:],
                             return_errors=True)
    assert [type(r).__name__ for r in got[:3]] == names[:3]


def test_default_device_is_cuda_and_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(PA, "_decode_body", lambda *a, **k: ran.append(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        PH.decompress_many([zlib.compress(b"x" * 1000)] * 3,
                           return_errors=True)
    assert not ran


@pytest.mark.parametrize("fmt,level", [("zlib", 1), ("gzip", 6),
                                       ("raw", 9)])
def test_compress_many_equals_tbz(fmt, level):
    kw = {"mtime": 0} if fmt == "gzip" else {}
    mine = PH.compress_many(DATAS, fmt, level, threads=4, **kw)
    assert mine == TH.compress_many(DATAS, fmt, level, **kw)
    wbits = {"zlib": 15, "gzip": 31, "raw": -15}[fmt]
    assert [zlib.decompress(c, wbits) for c in mine] == DATAS


def test_compress_many_errors():
    got = PH.compress_many([b"abc", b"def"], "gzip", 6,
                           zdict=b"dictionary", return_errors=True)
    theirs = TH.compress_many([b"abc", b"def"], "gzip", 6,
                              zdict=b"dictionary", return_errors=True)
    assert [type(r) for r in got] == [type(r) for r in theirs] == \
        [ValueError, ValueError]
    with pytest.raises(ValueError):
        PH.compress_many([b"abc"], "gzip", zdict=b"dictionary")


def test_counters_and_stage_timers_lose_nothing_under_threads():
    """More threads than cores, a short switch interval: every count
    and every stage call lands."""
    n_threads, per = 16, 2000
    interval = sys.getswitchinterval()
    m = profiling.Metrics()
    _cuda.reset_counts()
    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait(timeout=30)
        for _ in range(per):
            _cuda.count("crc32")
            with m.stage("s", 3):
                pass

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    try:
        sys.setswitchinterval(1e-6)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    counts = _cuda.launch_counts()
    _cuda.reset_counts()
    assert counts["crc32"] == n_threads * per
    assert m.stages["s"].calls == n_threads * per
    assert m.stages["s"].bytes == 3 * n_threads * per
