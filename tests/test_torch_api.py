"""Public entry point parity: tbz_torch.decompress(..., device="cpu")
against tbz.api.decompress(..., backend="device") and stdlib zlib/gzip
(bytes: tolerance 0). The default device is cuda, which must raise on a
machine with no card and never run on the CPU."""

import gzip
import zlib

import jax
import pytest
import torch

import tbz_torch
from tbz import api as TA
from tbz_torch import api as PA

from torch_util import corpus, mixed_blocks, raw_deflate


@pytest.fixture(autouse=True)
def _release_xla_executables():
    """Free tbz's compiled XLA executables after each test: each holds
    hundreds of memory maps, and the whole suite runs in one process,
    under the kernel's limit of 65530 maps."""
    yield
    jax.clear_caches()


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


@pytest.fixture
def frontend_config():
    """Set Config.frontend in both packages; restore both afterwards."""
    from tbz.utils import config as TC
    from tbz_torch.utils import config as PC
    saved = (TC.get_config(), PC.get_config())

    def use(fe):
        TC.set_config(TC.Config(frontend=fe))
        PC.set_config(PC.Config(frontend=fe))
    yield use
    TC.set_config(saved[0])
    PC.set_config(saved[1])


FORMATS = {
    "raw": lambda d: raw_deflate(d, 6),
    "zlib": lambda d: zlib.compress(d, 1),
    "gzip": lambda d: gzip.compress(d, 9),
}


@pytest.mark.parametrize("fe", ["auto", "native", "python", "device"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_every_frontend_and_format(frontend_config, fe, fmt):
    """Declined bodies (under 64 KB) take the configured frontend and the
    flat span resolver in both packages: the same bytes, zlib's."""
    frontend_config(fe)
    data = corpus(90, 12 << 10)
    payload = FORMATS[fmt](data)
    assert both(payload, format=fmt) == data


def test_device_frontend_static_only_stream(frontend_config):
    """A static-only stream of 64 KB and more: the fused decode declines
    it, and frontend='device' takes the speculative tier."""
    frontend_config("device")
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    data = corpus(91, 256 << 10)
    payload = co.compress(data) + co.flush()
    assert len(payload) >= 65536
    assert both(payload, format="raw") == data


def test_declined_body_resolves_with_flat_spans(monkeypatch):
    """resolve_core runs only when the flat resolver refuses the stream
    (2 GB and more: ValueError) or reports ERR_PLAN_DEPTH."""
    from tbz_torch import errors as PE
    from tbz_torch.ops import resolve as R
    from tbz_torch.ops import resolve_spans as RS
    data = corpus(92, 20 << 10)
    payload = zlib.compress(data, 6)
    calls = []
    real = R.resolve_device
    monkeypatch.setattr(R, "resolve_device",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    assert tbz_torch.decompress(payload, device="cpu") == data
    assert not calls
    for exc in (ValueError("too large"),
                PE.DeflateError("depth", PE.ERR_PLAN_DEPTH)):
        def refuse(*a, exc=exc, **k):
            raise exc
        monkeypatch.setattr(RS, "resolve_flat_device", refuse)
        assert tbz_torch.decompress(payload, device="cpu") == data
    assert len(calls) == 2
    monkeypatch.setattr(RS, "resolve_flat_device", lambda *a, **k: (
        _ for _ in ()).throw(PE.DeflateError("bad", PE.ERR_BAD_DISTANCE)))
    with pytest.raises(PE.DeflateError):
        tbz_torch.decompress(payload, device="cpu")
    assert len(calls) == 2


def _auto_payloads():
    """(payload, format, expected bytes or None for an error) for the
    backend="auto" parity test: the formats above and the error payloads
    of test_error_classes_match."""
    d = corpus(93, 40 << 10)
    z = zlib.compress(corpus(7, 100 << 10), 6)
    d1, d2 = corpus(4, 150 << 10), corpus(5, 30 << 10)
    mixed = mixed_blocks(6)
    return {
        "raw": (raw_deflate(d, 9), "raw", d),
        "zlib": (zlib.compress(d, 1), "zlib", d),
        "gzip": (gzip.compress(d, 9), "gzip", d),
        "gzip_two_members": (gzip.compress(d1) + gzip.compress(d2), "auto",
                             d1 + d2),
        "mixed_blocks": (mixed, "raw", zlib.decompress(mixed, -15)),
        "truncated": (z[:len(z) // 2], "auto", None),
        "bad_adler": (z[:-1] + bytes([z[-1] ^ 1]), "auto", None),
    }


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:  # the class is compared below
        return None, e


@pytest.mark.parametrize("case", sorted(_auto_payloads()))
def test_auto_backend_matches_tbz(case, monkeypatch):
    """backend="auto" (tbz's default: the native host inflate) through
    both packages: equal bytes, or equal error classes, and zlib's
    result. Needs no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    payload, fmt, want = _auto_payloads()[case]
    ref, ref_err = _outcome(lambda: TA.decompress(payload, fmt,
                                                  backend="auto"))
    mine, mine_err = _outcome(lambda: tbz_torch.decompress(
        payload, fmt, backend="auto"))
    if want is None:
        with pytest.raises(zlib.error):
            zlib.decompress(payload)
        assert isinstance(mine_err, tbz_torch.DeflateError)
        assert type(mine_err).__name__ == type(ref_err).__name__
    else:
        assert ref_err is None and mine_err is None
        assert mine == ref == want


def test_auto_backend_from_config(monkeypatch):
    """Config(backend="auto") through set_config is the host route too;
    device_resident=True with "auto" raises, as it does with "host"."""
    from tbz_torch.utils import config as PC
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    saved = PC.get_config()
    data = corpus(94, 30 << 10)
    payload = gzip.compress(data, 6)
    try:
        PC.set_config(PC.Config(backend="auto"))
        assert tbz_torch.decompress(payload) == data
        assert tbz_torch.decompress(payload) == TA.decompress(payload)
    finally:
        PC.set_config(saved)
    for backend in ("auto", "host"):
        with pytest.raises(ValueError, match="device backend"):
            tbz_torch.decompress(payload, backend=backend,
                                 device_resident=True)
