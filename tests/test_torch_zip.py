"""The port's ZIP container against tbz's and stdlib zipfile: ZipWriter
blobs equal tbz's (tolerance 0), ZipReader reads what tbz and zipfile
read and raises tbz's classes, ZIP64 fields, and read_all's routes:
backend="host" pairs deflate entries through the native paired inflate,
the default (device) backend never does (here with device="cpu", the
kernels' plain versions)."""

import io
import zipfile

import numpy as np
import pytest

from tbz import errors as TE
from tbz.formats import zip_fmt as TZ
from tbz_torch import errors as PE
from tbz_torch.formats import zip_fmt as PZ
from tbz_torch.native import loader as PL

from torch_util import corpus

MEMBERS = {
    "big.txt": corpus(81, 150_000),           # past the fused 64 KB
    "small.bin": corpus(82, 3000),
    "dir/ünïcode.txt": b"tiny",
    "random": np.random.default_rng(83).integers(
        0, 256, 5000, dtype=np.uint8).tobytes(),  # stored: no gain
    "empty": b"",
    "runs": bytes(70_000),
}


def _write(mod, level=6, **kw):
    w = mod.ZipWriter()
    for i, (name, data) in enumerate(MEMBERS.items()):
        w.write(name, data, level=level, **kw)
    return w.getvalue()


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_zip_writer_matches_tbz(level):
    blob = _write(PZ, level)
    assert blob == _write(TZ, level)
    zf = zipfile.ZipFile(io.BytesIO(blob))
    assert zf.testzip() is None
    assert {n: zf.read(n) for n in zf.namelist()} == MEMBERS


@pytest.mark.parametrize("kw", [{"method": 0}, {"method": 8},
                                {"force_zip64": True}])
def test_zip_writer_options_match_tbz(kw):
    blob = _write(PZ, 6, **kw)
    assert blob == _write(TZ, 6, **kw)
    zf = zipfile.ZipFile(io.BytesIO(blob))
    assert {n: zf.read(n) for n in zf.namelist()} == MEMBERS
    with pytest.raises(ValueError):
        PZ.ZipWriter().write("x", b"y", method=12)


def _stdlib_blob():
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for i, (name, data) in enumerate(MEMBERS.items()):
            method = zipfile.ZIP_STORED if i % 3 == 2 else \
                zipfile.ZIP_DEFLATED
            z.writestr(zipfile.ZipInfo(name), data, compress_type=method)
        z.comment = b"archive comment"
    return buf.getvalue()


@pytest.mark.parametrize("source", ["stdlib", "ours"])
@pytest.mark.parametrize("route", [{"device": "cpu"}, {"backend": "host"},
                                   {"backend": "auto"}])
def test_zip_reader_matches_tbz_and_zipfile(source, route):
    blob = _stdlib_blob() if source == "stdlib" else _write(PZ)
    mine, ref = PZ.ZipReader(blob, **route), TZ.ZipReader(blob)
    assert mine.names() == ref.names() == list(MEMBERS)
    assert mine.infolist() == [PZ.ZipEntry(**vars(e)) for e in ref.entries]
    zf = zipfile.ZipFile(io.BytesIO(blob))
    for name in MEMBERS:
        assert mine.read(name) == ref.read(name) == zf.read(name)
    assert mine.read_all() == ref.read_all() == MEMBERS
    with pytest.raises(KeyError):
        mine.read("absent")


def _outcome(fn):
    try:
        fn()
        return None
    except (PE.DeflateError, TE.DeflateError) as e:
        return type(e).__name__, e.code


@pytest.mark.parametrize("route", [{"device": "cpu"}, {"backend": "host"}])
def test_zip_reader_errors_match_tbz(route):
    blob = _write(PZ)
    e = PZ.ZipReader(blob).entries[0]          # big.txt, deflate
    local_crc = bytearray(blob)
    local_crc[e.local_offset + 14] ^= 1        # not read: the directory's is
    dir_crc = bytearray(blob)
    dir_crc[blob.find(b"PK\x01\x02") + 16] ^= 1
    body = bytearray(blob)
    body[e.local_offset + 30 + len(e.name) + 50] ^= 0x5A
    cases = {"directory CRC": bytes(dir_crc), "body": bytes(body),
             "no EOCD": blob[:-22], "bad local header":
             blob[:e.local_offset] + b"XX" + blob[e.local_offset + 2:]}
    assert PZ.ZipReader(bytes(local_crc), **route).read(e.name) == \
        MEMBERS[e.name]
    for what, bad in cases.items():
        def mine():
            return PZ.ZipReader(bad, **route).read_all()

        def ref():
            return TZ.ZipReader(bad).read_all()
        got = _outcome(mine)
        assert got is not None, what
        assert got == _outcome(ref), what
        got = _outcome(lambda: PZ.ZipReader(bad, **route).read(e.name))
        assert got == _outcome(lambda: TZ.ZipReader(bad).read(e.name)), what


def test_zip64_fields_match_tbz():
    bio = io.BytesIO()
    with zipfile.ZipFile(bio, "w", zipfile.ZIP_DEFLATED) as z:
        with z.open("a.bin", "w", force_zip64=True) as f:
            f.write(b"data! " * 5000)
        z.writestr("b.txt", "bee")
    for blob in (bio.getvalue(), _write(PZ, 6, force_zip64=True)):
        got = PZ.parse_directory(blob)
        assert [vars(e) for e in got] == [vars(e) for e in
                                          TZ.parse_directory(blob)]
        r = PZ.ZipReader(blob, device="cpu")
        assert r.read_all() == TZ.ZipReader(blob).read_all()
    w = PZ.ZipWriter()
    for i in range(65_600):
        w.write(f"f{i}", b"x", method=0)
    blob = w.getvalue()
    assert blob[-22 - 20 - 56:-22 - 20 - 52] == b"PK\x06\x06"
    assert len(PZ.parse_directory(blob)) == 65_600
    assert len(zipfile.ZipFile(io.BytesIO(blob)).namelist()) == 65_600
    assert PZ.ZipReader(blob, device="cpu").read("f65599") == b"x"
    ext = PZ._zip64_fields(b"\x01\x00\x10\x00" + (7).to_bytes(8, "little")
                           + (9).to_bytes(8, "little"), 0xFFFFFFFF,
                           0xFFFFFFFF, 5)
    assert ext == (7, 9, 5)
    with pytest.raises(PE.DeflateError):
        PZ._zip64_fields(b"", 0xFFFFFFFF, 1, 1)


def test_read_all_on_the_host_pairs_entries(monkeypatch):
    calls = []
    real = PL.inflate_pair

    def counted(*a):
        calls.append(a[2:])
        return real(*a)

    monkeypatch.setattr(PL, "inflate_pair", counted)
    blob = _write(PZ, 6)
    for backend in ("host", "auto"):
        calls.clear()
        assert PZ.ZipReader(blob, backend=backend).read_all() == MEMBERS
        n_defl = sum(e.method == 8 for e in PZ.parse_directory(blob))
        assert len(calls) == n_defl // 2 > 0


def test_read_all_on_the_device_backend_never_pairs(monkeypatch):
    def refuse(*a):
        raise AssertionError("inflate_pair on the device backend")

    monkeypatch.setattr(PL, "inflate_pair", refuse)
    blob = _write(PZ, 6)
    assert PZ.ZipReader(blob, device="cpu").read_all() == MEMBERS
    assert PZ.ZipReader(blob, backend="device",
                        device="cpu").read_all() == MEMBERS
