"""Batched member decode parity: tbz_torch.parallel.shard.
decode_streams_sharded on a one-entry CPU mesh (plain versions of
kernels 5-7) against tbz.parallel.shard.decode_streams_sharded on the
8-device CPU mesh of tests/conftest.py and stdlib zlib/gzip, for the cases of
tests/test_parallel.py: gzip members, mixed formats, size buckets with
multi-member gzip, per-stream errors, the trailing-garbage policy and
device-resident rows. Bytes: tolerance 0."""

import gzip
import zlib

import jax
import numpy as np
import pytest
import torch

from tbz.parallel import shard as TS
from tbz.parallel.mesh import make_mesh
from tbz_torch import api as PA
from tbz_torch import errors as PE
from tbz_torch.parallel import shard as PS
from tbz_torch.parallel.mesh import make_mesh as port_mesh

from torch_util import corpus, raw_deflate


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, jax.devices()
    return make_mesh(sp=1)


CPU = port_mesh(devices=["cpu"])


def both(payloads, mesh, **kw):
    mine = PS.decode_streams_sharded(payloads, CPU, **kw)
    ref = TS.decode_streams_sharded(payloads, mesh, **kw)
    assert [type(o).__name__ if isinstance(o, Exception) else o
            for o in mine] == \
        [type(o).__name__ if isinstance(o, Exception) else o for o in ref]
    return mine


def test_member_parallel_gzip(mesh):
    streams = [corpus(i, 10000 + 3000 * i) for i in range(11)]
    payloads = [gzip.compress(s, 9) for s in streams]
    assert both(payloads, mesh, format="gzip") == streams


def test_member_parallel_mixed_formats(mesh):
    streams = [corpus(i + 20, 5000 + i * 777) for i in range(6)]
    payloads = [gzip.compress(streams[0], 6), zlib.compress(streams[1], 9),
                gzip.compress(streams[2], 1), zlib.compress(streams[3], 0),
                gzip.compress(streams[4], 9), raw_deflate(streams[5], 6)]
    assert both(payloads, mesh, format="auto") == streams


def test_member_parallel_checksum_detects_corruption(mesh):
    streams = [corpus(i, 20000) for i in range(3)]
    payloads = [bytearray(gzip.compress(s)) for s in streams]
    payloads[1][-6] ^= 0xFF  # corrupt CRC of member 1
    with pytest.raises(PE.ChecksumError):
        PS.decode_streams_sharded([bytes(p) for p in payloads], CPU,
                                  format="gzip")


def test_sharded_size_buckets_and_multimember(mesh):
    """Members of 4 KB..300 KB fall in several power-of-two buckets;
    two payloads are three-member gzip."""
    rng = np.random.default_rng(5)
    streams, payloads = [], []
    for i in range(9):
        s = corpus(i, int(rng.choice([4096, 20000, 100000, 300000])))
        streams.append(s)
        payloads.append(zlib.compress(s, 6) if i % 2 else
                        gzip.compress(s, 6))
    for i in (17, 18):
        parts = [corpus(i * 10 + j, 30000) for j in range(3)]
        streams.append(b"".join(parts))
        payloads.append(b"".join(gzip.compress(p, 6) for p in parts))
    assert len({PS._bucket_key(m) for p in payloads
                for m in PS._tokenize_members(p, "auto")}) >= 3
    assert both(payloads, mesh) == streams


def test_sharded_per_stream_errors(mesh):
    """One corrupt member reports its error value at its position; the
    others decode; without return_errors the first error is raised."""
    streams = [corpus(40 + i, 50000) for i in range(5)]
    payloads = [gzip.compress(s, 6) for s in streams]
    bad = bytearray(payloads[2])
    bad[len(bad) // 2] ^= 0xFF  # corrupt mid-body
    payloads[2] = bytes(bad)
    outs = both(payloads, mesh, return_errors=True)
    for i, o in enumerate(outs):
        if i == 2:
            assert isinstance(o, PE.DeflateError)
        else:
            assert o == streams[i]
    with pytest.raises(PE.DeflateError):
        PS.decode_streams_sharded(payloads, CPU)


def test_trailing_garbage_policy_agrees_across_surfaces(mesh):
    """Bytes after a complete member that do not start another member are
    benign trailing garbage, for zlib and gzip framing, in the batched
    decode and in the one-shot decompress alike."""
    data = corpus(70, 20000)
    for fmt, good in (("zlib", zlib.compress(data, 6)),
                      ("gzip", gzip.compress(data, 6))):
        junky = good + b"junk!"
        assert both([good, junky], mesh, format=fmt,
                    return_errors=True) == [data, data], fmt
        out, info = PA.decompress(junky, fmt, device="cpu", with_info=True)
        assert out == data and info.unused_data == b"junk!", fmt


def test_shard_device_resident_outputs(mesh):
    """device_resident=True returns (row tensor, length) members on the
    device (here the CPU) and fetches no body bytes."""
    streams = [corpus(80 + i, 30000 + 997 * i) for i in range(4)]
    payloads = [zlib.compress(s, 6) for s in streams]
    payloads.append(gzip.compress(streams[0]) + gzip.compress(streams[1]))
    outs = PS.decode_streams_sharded(payloads, CPU, device_resident=True)
    ref = TS.decode_streams_sharded(payloads, mesh, device_resident=True)
    for members, ref_members, want in zip(outs, ref,
                                          streams + [streams[0]
                                                     + streams[1]]):
        assert len(members) == len(ref_members)
        got = b""
        for (row, n), (ref_row, ref_n) in zip(members, ref_members):
            assert isinstance(row, torch.Tensor) and row.device.type == "cpu"
            assert n == ref_n
            assert row[:n].numpy().tobytes() == \
                bytes(np.asarray(ref_row[:ref_n]))
            got += row[:n].numpy().tobytes()
        assert got == want


def test_no_host_retry_of_device_failures(monkeypatch):
    """A kernel or launch failure raises; it is not re-resolved on the
    host (tbz's host_retry is deliberately not ported)."""
    def boom(*a, **k):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(PS, "_resolve_batch", boom)
    with pytest.raises(RuntimeError, match="injected"):
        PS.decode_streams_sharded([gzip.compress(corpus(90, 5000))], CPU,
                                  return_errors=True)


def test_default_device_is_cuda_and_raises_without_card(monkeypatch):
    """mesh=None is a mesh over the local CUDA cards; with none it
    raises (it never becomes a CPU mesh)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.decode_streams_sharded([zlib.compress(b"x" * 1000)])
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.decode_streams_sharded([zlib.compress(b"x" * 1000)], None,
                                  format="zlib")
