"""tbz_torch.gzip_compat against stdlib gzip first and tbz.gzip_compat
wherever tbz agrees with stdlib: compress/decompress, multi-member
streams, GzipFile's read surface (read, read1, peek, readline, seek,
tell, rewind, mtime), write, append and text modes, and stdlib's error
classes (EOFError for truncation, BadGzipFile for framing and
checksums). Host code on both sides. Bytes and error classes:
tolerance 0."""

import gzip
import io
import os

import pytest

import tbz.gzip_compat as TG
import tbz_torch.gzip_compat as PG

from torch_util import corpus

DATA = corpus(71, 150 << 10)


def test_compress_decompress_parity():
    blob = PG.compress(DATA, 6, mtime=4242)
    assert blob == TG.compress(DATA, 6, mtime=4242)
    assert gzip.decompress(blob) == DATA
    assert PG.decompress(blob) == DATA
    assert PG.decompress(gzip.compress(DATA, 9)) == DATA
    with gzip.GzipFile(fileobj=io.BytesIO(blob)) as f:
        f.read(1)
        assert f.mtime == 4242
    assert PG.decompress(PG.compress(b"")) == b"" == gzip.decompress(
        PG.compress(b""))


def test_multi_member_both_ways():
    a, b = DATA[:40000], DATA[40000:70000]
    mm = gzip.compress(a) + PG.compress(b, 6) + gzip.compress(a, 1)
    assert PG.decompress(mm) == a + b + a == gzip.decompress(mm)
    assert TG.decompress(mm) == a + b + a


def _ops(f):
    """The same reads, seeks and peeks on a read-mode GzipFile."""
    got = [f.read(7777), f.read1(100), f.peek(16)[:16], f.tell()]
    got += [f.seek(5000), f.read(10), f.seek(100), f.read(10),
            f.seek(-50, io.SEEK_CUR), f.read(20), f.tell()]
    got += [f.seek(-30, io.SEEK_END), f.read(), f.tell(), f.read(5)]
    f.rewind()
    got += [f.tell(), f.readline(), f.read(3), f.mtime]
    return got


def test_gzipfile_read_surface_equals_stdlib():
    sb = io.BytesIO()
    with gzip.GzipFile(fileobj=sb, mode="wb", filename="n.txt",
                       mtime=999) as g:
        g.write(DATA)
    blob = sb.getvalue()
    want = _ops(gzip.GzipFile(fileobj=io.BytesIO(blob), mode="rb"))
    f = PG.GzipFile(fileobj=io.BytesIO(blob), mode="rb")
    assert f.mode == PG.READ == gzip.READ and f.readable()
    assert _ops(f) == want
    assert _ops(TG.GzipFile(fileobj=io.BytesIO(blob), mode="rb")) == want
    with PG.open(io.BytesIO(blob), "rb") as f2:
        assert b"".join(f2.readlines()) == DATA
    with PG.open(io.BytesIO(blob + gzip.compress(b"x\ny"))) as f3:
        chunks = iter(lambda: f3.read(4096), b"")
        assert b"".join(chunks) == DATA + b"x\ny"


def test_gzipfile_write_append_text(tmp_path):
    p, tp = os.fspath(tmp_path / "t.gz"), os.fspath(tmp_path / "u.gz")
    for mod, path in ((PG, p), (TG, tp)):
        with mod.open(path, "wb", 6) as f:
            assert f.mode == mod.WRITE and f.writable()
            f.write(DATA[:4000])
            f.flush()  # a sync flush mid-member
            f.write(DATA[4000:])
            f.seek(len(DATA) + 10)  # forward: zeros
            assert f.tell() == len(DATA) + 10
            with pytest.raises(OSError):
                f.seek(0)
    raw = open(p, "rb").read()
    assert raw[3] & 8 and raw[10:12] == b"t\x00"  # FNAME, stdlib's rule
    with gzip.open(p, "rb") as f:
        assert f.read() == DATA + bytes(10)
    with PG.open(p, "ab", 6) as f:
        f.write(b"MORE")
    with gzip.open(p, "rb") as f:
        assert f.read() == DATA + bytes(10) + b"MORE"
    # text modes, both directions
    x = os.fspath(tmp_path / "x.gz")
    with PG.open(x, "wt", encoding="utf-8") as f:
        f.write("hello\nwörld\n")
    with gzip.open(x, "rt", encoding="utf-8") as f:
        assert f.read() == "hello\nwörld\n"
    with gzip.open(x, "wt", encoding="utf-8") as f:
        f.write("a\nb\n")
    with PG.open(x, "rt", encoding="utf-8") as f:
        assert f.readlines() == ["a\n", "b\n"]
    for bad in (lambda: PG.open(x, "rbt"),
                lambda: PG.open(x, "rb", encoding="utf-8"),
                lambda: PG.GzipFile(x, "rt")):
        with pytest.raises(ValueError):
            bad()


def test_write_mode_bytes_equal_tbz(tmp_path):
    outs = []
    for mod in (PG, TG):
        b = io.BytesIO()
        with mod.GzipFile(fileobj=b, mode="wb", compresslevel=6,
                          mtime=7) as f:
            for i in range(0, len(DATA), 30000):
                f.write(DATA[i:i + 30000])
        outs.append(b.getvalue())
    assert outs[0] == outs[1]
    assert gzip.decompress(outs[0]) == DATA


def test_misuse_raises_like_stdlib(tmp_path):
    blob = gzip.compress(DATA[:1000])
    for mod in (gzip, PG):
        r = mod.GzipFile(fileobj=io.BytesIO(blob), mode="rb")
        with pytest.raises(OSError):
            r.write(b"x")
        r.close()
        with pytest.raises(ValueError):
            r.read()
        w = mod.GzipFile(fileobj=io.BytesIO(), mode="wb")
        with pytest.raises(OSError):
            w.read()
        w.close()
    with pytest.raises(TypeError):
        PG.open(123)


def _error_class(call):
    try:
        call()
    except Exception as e:  # noqa: BLE001 - the class is the result
        return ("EOFError" if isinstance(e, EOFError) else
                "BadGzipFile" if type(e).__name__ == "BadGzipFile" else
                type(e).__name__)
    return None


def test_error_classes_match_stdlib():
    full = gzip.compress(DATA[:30000], 6)
    bad_crc = bytearray(full)
    bad_crc[-5] ^= 0xFF
    bad_size = bytearray(full)
    bad_size[-2] ^= 0xFF
    cases = [full[:-5], full[:20], bytes(bad_crc), bytes(bad_size),
             b"\x00\x01notgzip", b"\0\0", b"\x1f\x8b\x09" + full[3:],
             full + full[:-3]]
    for payload in cases:
        want = _error_class(lambda: gzip.decompress(payload))
        assert want in ("EOFError", "BadGzipFile")
        assert _error_class(lambda: PG.decompress(payload)) == want
        assert _error_class(lambda: TG.decompress(payload)) == want
        want_f = _error_class(
            lambda: gzip.GzipFile(fileobj=io.BytesIO(payload)).read())
        assert _error_class(
            lambda: PG.GzipFile(fileobj=io.BytesIO(payload)).read()) == \
            want_f
    assert issubclass(PG.BadGzipFile, OSError)


# bytes after a complete member: stdlib skips zero padding and reads
# anything else as the start of another member
AFTER = [b"", b"\0\0", b"\0" * 10 + b"MEMBER\0", b"junk", b"\x1f",
         b"\0\0\x1f\x8b", b"\x1f\x8bjunk", b"\x1f\x8b\x09" + bytes(9)]


@pytest.mark.parametrize("after", AFTER, ids=range(len(AFTER)))
def test_bytes_after_a_member_follow_stdlib(after, monkeypatch):
    a = DATA[:20000]
    member = gzip.compress(DATA[20000:25000])
    payload = gzip.compress(a) + after.replace(b"MEMBER", member)

    def outcome(call):
        try:
            return call()
        except (EOFError, OSError) as e:
            return "BadGzipFile" if "BadGzipFile" in type(e).__name__ \
                else type(e).__name__
    want = outcome(lambda: gzip.decompress(payload))
    assert outcome(lambda: PG.decompress(payload)) == want
    for chunk in (1 << 17, 7):  # GzipFile's reads of its file
        monkeypatch.setattr(PG, "_READ_CHUNK", chunk)
        assert outcome(lambda: PG.GzipFile(
            fileobj=io.BytesIO(payload)).read()) == want


def test_tbz_stops_at_the_first_bytes_after_a_member():
    """The departure of the reference that the port repairs: tbz drops
    a zero-padded second member and accepts trailing garbage, where
    stdlib and the port read the member and raise on the garbage."""
    a, b = gzip.compress(DATA[:20000]), gzip.compress(DATA[20000:25000])
    assert TG.decompress(a + b"\0\0" + b) == DATA[:20000]
    assert TG.decompress(a + b"junk") == DATA[:20000]
    assert PG.decompress(a + b"\0\0" + b) == DATA[:25000]
    with pytest.raises(PG.BadGzipFile):
        PG.decompress(a + b"junk")
