"""decompress_into, decompress_file and decompress_stream against tbz's
and stdlib zlib/gzip (bytes: tolerance 0): decompress_into on small
buffers, with a preset dictionary and a corrupt gzip member, raising the
native library's build error where tbz would fall back to its Python
path; decompress_file with device="cpu" (the kernels' plain versions)
and backend="host"; decompress_stream over chunked and moved files; and
the public helpers iosrc.as_buffer, checksums.pad_front and
ops.resolve.resolve_device(out_capacity=)."""

import gzip
import zlib

import numpy as np
import pytest
import torch

import jax

from tbz import api as TA, errors as TE
from tbz import checksums as TC, iosrc as TI
from tbz import reference as TRef
from tbz.ops import resolve as TR
from tbz_torch import api as PA, errors as PE
from tbz_torch import checksums as PC, iosrc as PI
from tbz_torch.native import loader as PL
from tbz_torch.ops import resolve as PR

from torch_util import corpus, raw_deflate


@pytest.fixture(autouse=True, scope="module")
def _free_xla_executables():
    """Free tbz's compiled XLA executables after this module (each holds
    hundreds of memory maps; the suite runs in one process)."""
    yield
    jax.clear_caches()

DATA = corpus(71, 200_000)
ZD = corpus(72, 8000)


def _payloads():
    co = zlib.compressobj(9, zlib.DEFLATED, 15, zdict=ZD)
    return {
        "raw": (raw_deflate(DATA, 6), "raw", b"", DATA),
        "raw zdict": (raw_deflate(ZD[:3000] + DATA[:9000], 9, ZD), "raw",
                      ZD, ZD[:3000] + DATA[:9000]),
        "zlib": (zlib.compress(DATA, 1), "auto", b"", DATA),
        "zlib zdict": (co.compress(DATA[:50000]) + co.flush(), "zlib", ZD,
                       DATA[:50000]),
        "gzip 3 members": (gzip.compress(DATA[:10]) + gzip.compress(b"")
                           + gzip.compress(DATA), "auto", b"",
                           DATA[:10] + DATA),
        "stored": (zlib.compress(DATA[:70000], 0), "zlib", b"",
                   DATA[:70000]),
    }


def _outcome(fn):
    try:
        return fn()
    except TE.DeflateError as e:      # tbz's classes
        return type(e).__name__, e.code
    except PE.DeflateError as e:      # the port's
        return type(e).__name__, e.code


@pytest.mark.parametrize("name", list(_payloads()))
@pytest.mark.parametrize("kind", ["bytearray", "ndarray", "memoryview"])
def test_decompress_into_matches_tbz(name, kind):
    payload, fmt, zd, want = _payloads()[name]

    def run(mod, slack):
        n = len(want) + slack
        buf = {"bytearray": bytearray(n), "ndarray": np.zeros(n, np.uint8),
               "memoryview": memoryview(bytearray(n))}[kind]
        got = mod.decompress_into(payload, buf, fmt, zdict=zd)
        return got, bytes(memoryview(buf)[:got])

    assert run(PA, 64) == run(TA, 64) == (len(want), want)


@pytest.mark.parametrize("name", list(_payloads()))
def test_decompress_into_small_buffers_raise_like_tbz(name):
    payload, fmt, zd, want = _payloads()[name]
    for n in sorted({0, 1, len(want) // 2, max(0, len(want) - 1)}):
        if n >= len(want):
            continue
        got = _outcome(lambda: PA.decompress_into(payload, bytearray(n), fmt,
                                                  zdict=zd))
        assert got == _outcome(lambda: TA.decompress_into(
            payload, bytearray(n), fmt, zdict=zd))
        assert got[0] == "DeflateError", (name, n, got)


def test_decompress_into_corrupt_gzip_member():
    second = bytearray(gzip.compress(DATA[:30000]))
    second[-7] ^= 0x10                     # its CRC-32
    payload = gzip.compress(DATA[:100]) + bytes(second)
    with pytest.raises(gzip.BadGzipFile):
        gzip.decompress(payload)
    got = _outcome(lambda: PA.decompress_into(payload, bytearray(40000)))
    assert got == ("ChecksumError", PE.ERR_CHECKSUM)
    assert got == _outcome(lambda: TA.decompress_into(payload,
                                                      bytearray(40000)))
    n = PA.decompress_into(payload, bytearray(40000), verify=False)
    assert n == 30100
    trunc = gzip.compress(DATA[:30000])[:-20]
    assert _outcome(lambda: PA.decompress_into(trunc, bytearray(40000))) \
        == _outcome(lambda: TA.decompress_into(trunc, bytearray(40000)))


def test_decompress_into_rejects_read_only_buffers():
    for mod in (PA, TA):
        with pytest.raises(TypeError):
            mod.decompress_into(zlib.compress(b"abc"), b"xxxx")


def test_decompress_into_raises_the_native_build_error(monkeypatch):
    """tbz falls back to its Python decode when the library is missing;
    the port raises the build error."""
    err = RuntimeError("native build failed: b'no g++'")

    def missing():
        raise err

    monkeypatch.setattr(PL, "require", missing)
    monkeypatch.setattr(PL, "available", lambda: False)
    with pytest.raises(RuntimeError) as e:
        PA.decompress_into(zlib.compress(DATA[:100]), bytearray(200))
    assert e.value is err


@pytest.mark.parametrize("name", list(_payloads()))
def test_decompress_file_matches_tbz(name, tmp_path):
    payload, fmt, zd, want = _payloads()[name]
    p = tmp_path / "in.bin"
    p.write_bytes(payload)
    ref = TA.decompress_file(p, fmt, zdict=zd)
    assert ref == want
    assert PA.decompress_file(p, fmt, zdict=zd, device="cpu") == want
    assert PA.decompress_file(str(p), fmt, zdict=zd, backend="host") == want
    out = PA.decompress_file(p, fmt, zdict=zd, device="cpu",
                             device_resident=True)
    assert isinstance(out, torch.Tensor) and out.numpy().tobytes() == want


def test_decompress_file_errors_match_tbz(tmp_path):
    p = tmp_path / "bad.gz"
    bad = bytearray(gzip.compress(DATA[:5000]))
    bad[-8] ^= 1
    for payload in (bytes(bad), b"", gzip.compress(DATA)[:-9]):
        p.write_bytes(payload)
        got = _outcome(lambda: PA.decompress_file(p, device="cpu"))
        assert got == _outcome(lambda: TA.decompress_file(p))
        assert isinstance(got, tuple)
    with pytest.raises(FileNotFoundError):
        PA.decompress_file(tmp_path / "absent", device="cpu")


@pytest.mark.parametrize("chunk", [1, 1000, 1 << 20])
def test_decompress_stream_matches_tbz(chunk, tmp_path):
    payload = gzip.compress(DATA[:20000 if chunk == 1 else None])
    want = DATA[:20000 if chunk == 1 else None]
    p = tmp_path / "s.gz"
    p.write_bytes(payload)
    with open(p, "rb") as f, open(p, "rb") as g:
        got = list(PA.decompress_stream(f, chunk_size=chunk))
        assert got == list(TA.decompress_stream(g, chunk_size=chunk))
    assert b"".join(got) == want


def test_decompress_stream_resyncs_a_moved_file(tmp_path):
    p = tmp_path / "m.zlib"
    p.write_bytes(zlib.compress(DATA, 6))
    with open(p, "rb") as f:
        gen = PA.decompress_stream(f, chunk_size=4096)
        out = [next(gen)]
        f.seek(0)
        f.read(100)
        out += list(gen)
    assert b"".join(out) == DATA


def test_decompress_stream_zdict_and_truncation(tmp_path):
    import io
    _, _, zd, want = _payloads()["zlib zdict"]
    payload = _payloads()["zlib zdict"][0]
    assert b"".join(PA.decompress_stream(io.BytesIO(payload),
                                         zdict=zd)) == want
    for mod, cls in ((PA, PE.TruncatedError), (TA, TE.TruncatedError)):
        with pytest.raises(cls):
            list(mod.decompress_stream(io.BytesIO(payload[:-100]),
                                       zdict=zd))


def _sources():
    import array
    raw = DATA[:5000]
    return {"bytes": raw, "bytearray": bytearray(raw),
            "memoryview": memoryview(raw),
            "memoryview of uint32": memoryview(array.array("I", raw[:4000])),
            "ndarray": np.frombuffer(raw, np.uint8),
            "empty": b""}


@pytest.mark.parametrize("name", list(_sources()))
def test_as_buffer_matches_tbz(name):
    src = _sources()[name]
    got, ref = PI.as_buffer(src), TI.as_buffer(src)
    assert got.format == ref.format == "B"
    assert got.tobytes() == ref.tobytes()
    assert got.nbytes == ref.nbytes


def test_as_buffer_rejects_what_tbz_rejects():
    for src in ("text", [1, 2, 3], 7):
        for mod in (PI, TI):
            with pytest.raises(TypeError):
                mod.as_buffer(src)
    # tbz asserts the dtype (gone under -O); the port raises TypeError
    with pytest.raises(AssertionError):
        TI.as_buffer(np.zeros(4, np.int32))
    with pytest.raises(TypeError):
        PI.as_buffer(np.zeros(4, np.int32))


@pytest.mark.parametrize("n,padded", [(0, 16), (1, 16), (100, 4096),
                                      (4096, 4096), (5000, 65536)])
def test_pad_front_matches_tbz(n, padded):
    arr = np.frombuffer(DATA[:n], np.uint8)
    got = PC.pad_front(arr, padded)
    assert got.dtype == np.uint8 and got.shape == (padded,)
    np.testing.assert_array_equal(got, TC.pad_front(arr, padded))


RESOLVE_PAYLOAD = raw_deflate(corpus(74, 30000), 6)


@pytest.mark.parametrize("extra", [0, 1, 40000])
def test_resolve_device_out_capacity_matches_tbz(extra):
    tape = TRef.tokenize_host(RESOLVE_PAYLOAD, 0).tape
    total = tape.total_out
    cap = total + extra
    out, n = PR.resolve_device(tape, RESOLVE_PAYLOAD, device="cpu",
                               out_capacity=cap)
    ref, rn = TR.resolve_device(tape, RESOLVE_PAYLOAD, out_capacity=cap)
    W = PR.W
    assert n == rn == total
    assert out.shape[0] == np.asarray(ref).shape[0] == W + cap
    got = out[W:W + total].numpy().tobytes()
    assert got == bytes(np.asarray(ref[W:W + total]))
    assert got == zlib.decompressobj(-15).decompress(RESOLVE_PAYLOAD)
    default, _ = PR.resolve_device(tape, RESOLVE_PAYLOAD, device="cpu")
    assert default[W:W + total].numpy().tobytes() == got


def test_resolve_device_too_small_capacity_raises():
    tape = TRef.tokenize_host(RESOLVE_PAYLOAD, 0).tape
    with pytest.raises(ValueError):
        PR.resolve_device(tape, RESOLVE_PAYLOAD, device="cpu",
                          out_capacity=tape.total_out - 1)
    with pytest.raises(AssertionError):   # tbz's assert
        TR.resolve_device(tape, RESOLVE_PAYLOAD,
                          out_capacity=tape.total_out - 1)
