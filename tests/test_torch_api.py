"""Public entry point parity: tbz_torch.decompress(..., device="cpu")
against tbz.api.decompress(..., backend="device") and stdlib zlib/gzip
(bytes: tolerance 0). The default device is cuda, which must raise on a
machine with no card and never run on the CPU."""

import gzip
import zlib

import pytest
import torch

import tbz_torch
from tbz import api as TA
from tbz_torch import api as PA

from torch_util import corpus, mixed_blocks, raw_deflate


def both(payload, **kw):
    mine = tbz_torch.decompress(payload, device="cpu", **kw)
    assert mine == TA.decompress(payload, backend="device", **kw)
    return mine


@pytest.mark.parametrize("size", [20 << 10, 160 << 10])
def test_raw(size):
    data = corpus(1, size)
    assert both(raw_deflate(data, 9), format="raw") == data


def test_zlib_with_zdict():
    zdict = corpus(2, 8 << 10)
    data = zdict[:4000] + corpus(3, 120 << 10)
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_DEFAULT_STRATEGY,
                          zdict)
    payload = co.compress(data) + co.flush()
    assert both(payload, zdict=zdict) == data


def test_gzip_multimember_and_info():
    d1, d2 = corpus(4, 150 << 10), corpus(5, 30 << 10)
    payload = gzip.compress(d1) + gzip.compress(d2)
    assert both(payload) == d1 + d2
    out, info = tbz_torch.decompress(payload + b"junk", device="cpu",
                                     with_info=True)
    assert out == d1 + d2 and info.format == "gzip"
    assert len(info.members) == 2 and info.unused_data == b"junk"


def test_mixed_blocks_and_host_backend():
    payload = mixed_blocks(6)
    want = zlib.decompress(payload, -15)
    assert both(payload, format="raw") == want
    assert tbz_torch.decompress(payload, "raw", backend="host") == want


def test_error_classes_match():
    payload = zlib.compress(corpus(7, 100 << 10), 6)
    for bad in (payload[:len(payload) // 2],
                payload[:-1] + bytes([payload[-1] ^ 1])):
        with pytest.raises(tbz_torch.DeflateError) as mine:
            tbz_torch.decompress(bad, device="cpu")
        with pytest.raises(Exception) as ref:
            TA.decompress(bad, backend="device")
        assert type(mine.value).__name__ == type(ref.value).__name__


def test_default_device_is_cuda_and_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(PA, "_decode_body",
                        lambda *a, **k: ran.append(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        tbz_torch.decompress(zlib.compress(b"x" * 1000))
    assert not ran  # nothing ran on the CPU instead


@pytest.mark.parametrize("size", [20 << 10, 160 << 10])
def test_device_backend_raises_without_native_library(monkeypatch, size):
    """A native library that did not build fails the device decode (both
    the fused route and the declined one) rather than tokenizing in
    Python; the host backend still has the Python oracle."""
    from tbz_torch.native import loader
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_build_error",
                        RuntimeError("native build failed: (test)"))
    data = corpus(8, size)
    payload = zlib.compress(data, 6)
    with pytest.raises(RuntimeError, match="native build failed"):
        tbz_torch.decompress(payload, device="cpu")
    assert tbz_torch.decompress(payload, backend="host") == data


def test_device_resident_returns_tensor_on_cpu():
    """device_resident returns the output as a uint8 tensor on the
    requested device (tests/test_torch_resident.py holds it against tbz)."""
    out = tbz_torch.decompress(zlib.compress(b"abc"), device="cpu",
                               device_resident=True)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out.numpy().tobytes() == b"abc"
