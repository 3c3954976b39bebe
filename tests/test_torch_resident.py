"""Device-resident decode parity: tbz_torch.decompress(device_resident=
True, device="cpu") (the plain versions of the kernels, checksums
verified with the plain versions of kernels 5 and 6) against
tbz.api.decompress(device_resident=True) (XLA on the CPU) and stdlib
zlib/gzip, for the cases of tests/test_api.py and tests/test_fused.py:
raw, zlib, single- and multi-member gzip on the fused and the declined
route, verify=False, checksum errors, and the host backend refused; and
host verification of fetched output. Bytes: tolerance 0."""

import gzip
import zlib

import numpy as np
import pytest
import torch

import tbz_torch
from tbz import api as TA
from tbz.ops import fused as TF
from tbz_torch import api as PA
from tbz_torch.ops import fused as PF

from torch_util import corpus


def resident(payload, **kw):
    mine = tbz_torch.decompress(payload, device="cpu", device_resident=True,
                                **kw)
    assert isinstance(mine, torch.Tensor) and mine.dtype == torch.uint8
    assert mine.device.type == "cpu"
    ref = TA.decompress(payload, device_resident=True, **kw)
    got = mine.numpy().tobytes()
    assert got == bytes(np.asarray(ref))
    return got


def test_decompress_device_resident():
    data = corpus(70, 120000)
    for fmt, payload in (("zlib", zlib.compress(data, 9)),
                         ("gzip", gzip.compress(data, 9)),
                         ("raw", zlib.compress(data, 9)[2:-4])):
        assert resident(payload, format=fmt) == data
    # multi-member gzip concatenates on the device
    mm = gzip.compress(data[:50000], 6) + gzip.compress(data[50000:], 6)
    assert resident(mm, format="gzip") == data
    with pytest.raises(ValueError):
        tbz_torch.decompress(zlib.compress(data, 6), backend="host",
                             device_resident=True)


def test_api_device_resident_fused():
    data = corpus(61, 768 << 10)
    payload = zlib.compress(data, 9)
    assert len(payload) >= PA.FUSED_MIN_BYTES
    assert resident(payload, backend="device") == data
    body = payload[2:-4]
    out, body_dev, total, _, stats = PF.decode_stream_fused(
        body, fetch=False, collect_stats=True, device="cpu")
    assert out is None and stats["out_d2h_bytes"] == 4
    assert body_dev[:total].numpy().tobytes() == data
    assert TF.decode_stream_fused(body, fetch=False)[0] is None


def test_verify_false_fetches_no_checksum(monkeypatch):
    data = corpus(71, 200 << 10)
    payload = gzip.compress(data[:150000]) + gzip.compress(data[150000:])
    calls = []
    real = PA._verify_device
    monkeypatch.setattr(PA, "_verify_device",
                        lambda *a: calls.append(a[0]) or real(*a))
    assert resident(payload, verify=False) == data
    assert calls == []
    assert resident(payload) == data
    assert calls == ["crc32", "crc32"]


@pytest.mark.parametrize("size", [20 << 10, 300 << 10])
def test_resident_checksum_mismatch_raises(size):
    """Both routes (declined under 64 KB, fused above) verify on the
    device and raise the class tbz raises."""
    data = corpus(72, size)
    for payload, pos in ((gzip.compress(data), -6),
                         (zlib.compress(data), -2)):
        bad = bytearray(payload)
        bad[pos] ^= 0xFF
        with pytest.raises(tbz_torch.ChecksumError):
            tbz_torch.decompress(bytes(bad), device="cpu",
                                 device_resident=True)
        with pytest.raises(Exception) as ref:
            TA.decompress(bytes(bad), device_resident=True)
        assert type(ref.value).__name__ == "ChecksumError"


@pytest.mark.parametrize("fmt", ["gzip", "zlib"])
@pytest.mark.parametrize("size", [20 << 10, 300 << 10])
def test_fetched_output_verified_on_host(monkeypatch, fmt, size):
    """Fetched output (the default) is verified with host zlib on both
    routes: no checksum kernel runs, and the bytes equal tbz's."""
    data = corpus(73, size)
    payload = (gzip.compress if fmt == "gzip" else zlib.compress)(data)
    calls = []
    monkeypatch.setattr(PA, "_verify_device",
                        lambda *a: calls.append(a[0]))
    got = tbz_torch.decompress(payload, device="cpu")
    assert got == TA.decompress(payload, backend="device") == data
    assert calls == []


@pytest.mark.parametrize("size", [20 << 10, 300 << 10])
def test_fetched_checksum_mismatch_raises(size):
    """A corrupt trailer fails host verification of fetched output with
    the class tbz raises."""
    data = corpus(74, size)
    for payload, pos in ((gzip.compress(data), -6),
                         (zlib.compress(data), -2)):
        bad = bytearray(payload)
        bad[pos] ^= 0xFF
        with pytest.raises(tbz_torch.ChecksumError):
            tbz_torch.decompress(bytes(bad), device="cpu")
        with pytest.raises(Exception) as ref:
            TA.decompress(bytes(bad), backend="device")
        assert type(ref.value).__name__ == "ChecksumError"
