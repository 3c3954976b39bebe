"""Config.device_checksums on fetched output: with the knob set, a
one-shot decompress on the device backend verifies each member's
Adler-32 / CRC-32 with the device tail kernels (here, device="cpu", their
plain versions) instead of host zlib, as tbz/api.py:155-163 does; unset,
or on the host backend, host zlib verifies it. Streams: zlib on the
fused route and on the declined route, a two-member gzip (one member
each way) and a raw stream. Bytes equal to tbz.decompress and to stdlib
(tolerance 0); a corrupted trailer raises the class tbz raises."""

import dataclasses
import gzip
import zlib

import pytest

import tbz_torch
from tbz import api as TA
from tbz_torch import checksums as PC
from tbz_torch.api import FUSED_MIN_BYTES
from tbz_torch.utils import config as PCFG
from tbz_torch.utils import profiling

from torch_util import corpus, raw_deflate

BIG = corpus(81, 300 << 10)
SMALL = corpus(82, 20 << 10)


def _streams():
    """name -> (payload, want, [(kind, total, prev)] the device
    checksums of its members)."""
    n, m = len(BIG), len(SMALL)
    return {
        "zlib fused": (zlib.compress(BIG, 6), BIG, [("adler32", n, 1)]),
        "zlib declined": (zlib.compress(SMALL, 6), SMALL,
                          [("adler32", m, 1)]),
        "gzip 2 members": (gzip.compress(BIG, 6) + gzip.compress(SMALL, 6),
                           BIG + SMALL, [("crc32", n, 0), ("crc32", m, 0)]),
        "raw": (raw_deflate(BIG, 6), BIG, []),
    }


@pytest.fixture
def knob():
    """Set Config.device_checksums for one test, then restore the
    process-wide config."""
    saved = PCFG.get_config()

    def set_(on: bool, **kw):
        PCFG.set_config(dataclasses.replace(saved, device_checksums=on,
                                            **kw))
    yield set_
    PCFG.set_config(saved)


@pytest.fixture
def spy(monkeypatch):
    """Records (kind, n, prev) of every device tail checksum call."""
    calls = []
    for kind in ("crc32", "adler32"):
        real = getattr(PC, kind + "_device_tail")

        def rec(data, n, prev, _k=kind, _real=real):
            calls.append((_k, n, prev))
            return _real(data, n, prev)
        monkeypatch.setattr(PC, kind + "_device_tail", rec)
    return calls


def test_streams_take_both_routes():
    s = _streams()
    assert len(s["zlib fused"][0]) - 6 >= FUSED_MIN_BYTES
    assert len(s["zlib declined"][0]) < FUSED_MIN_BYTES


@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("name", list(_streams()))
def test_fetched_decode_verifies_where_the_knob_says(knob, spy, name, on):
    payload, want, device_sums = _streams()[name]
    knob(on)
    got = tbz_torch.decompress(payload, device="cpu")
    assert got == want == TA.decompress(payload, backend="host")
    assert spy == (device_sums if on else [])


@pytest.mark.parametrize("name,pos", [
    ("zlib fused", -2), ("zlib declined", -1), ("gzip 2 members", -6),
    ("gzip 2 members", -5 - len(gzip.compress(SMALL, 6)))],
    ids=["zlib fused", "zlib declined", "gzip second member",
         "gzip first member"])
def test_corrupt_trailer_raises_tbz_s_class(knob, spy, name, pos):
    payload, _, _ = _streams()[name]
    bad = bytearray(payload)
    bad[pos] ^= 0x5A
    knob(True)
    with pytest.raises(tbz_torch.ChecksumError):
        tbz_torch.decompress(bytes(bad), device="cpu")
    assert spy, "the device checksum did not run"
    with pytest.raises(Exception) as ref:
        TA.decompress(bytes(bad), backend="host")
    assert type(ref.value).__name__ == "ChecksumError"
    if name.startswith("gzip"):
        with pytest.raises(gzip.BadGzipFile):
            gzip.decompress(bytes(bad))
    else:
        with pytest.raises(zlib.error):
            zlib.decompress(bytes(bad))


def test_host_backend_never_calls_the_device_checksum(knob, spy):
    knob(True)
    for payload, want, _ in _streams().values():
        assert tbz_torch.decompress(payload, backend="host") == want
    assert spy == []


def test_stage_is_tbz_s_verify_name(knob):
    payload, want, _ = _streams()["gzip 2 members"]
    knob(True, profile=True)
    profiling.metrics.reset()
    try:
        assert tbz_torch.decompress(payload, device="cpu") == want
        st = dict(profiling.metrics.stages)
    finally:
        profiling.metrics.reset()
    assert st["verify.crc32"].calls == 2
    assert st["verify.crc32"].bytes == len(want)
    assert "verify.crc32.device" not in st


@pytest.mark.parametrize("value,on", [("0", False), ("1", True),
                                      ("true", True), ("no", False)])
def test_env_var_parses(monkeypatch, value, on):
    monkeypatch.setenv("TBZ_TORCH_DEVICE_CHECKSUMS", value)
    assert PCFG.Config.from_env().device_checksums is on
    monkeypatch.delenv("TBZ_TORCH_DEVICE_CHECKSUMS")
    assert PCFG.Config.from_env().device_checksums is False
