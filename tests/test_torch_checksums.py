"""Checksum parity: tbz_torch.checksums (plain PyTorch versions of kernels
5 and 6 on the CPU) against tbz.checksums (XLA on the CPU) and stdlib
zlib, for the cases of tests/test_checksums.py: host combines, device
front and tail variants at the DATASETS lengths, streaming with prev, the
device combines, one pad size serving many lengths, and the row batches
of tbz/parallel/shard.py. Checksums are integers: tolerance 0."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbz import checksums as TC
from tbz.parallel import shard as TS
from tbz_torch import checksums as PC

_rng = np.random.default_rng(2026)


def _rand(n: int) -> bytes:
    return _rng.integers(0, 256, n, dtype=np.uint8).tobytes()


DATASETS = [b"", b"a", b"hello world", bytes(range(256)) * 17, _rand(4097),
            _rand(65536), b"\x00" * 10000, _rand(3)]


def _pad_len(n, m):
    return max(m, ((n + m - 1) // m) * m)


def _buffers(data: bytes, m: int):
    """(front-padded, tail-padded) uint8 buffers of a multiple of m."""
    arr = np.frombuffer(data, np.uint8)
    N = _pad_len(len(arr), m)
    back = np.zeros(N, np.uint8)
    back[:len(arr)] = arr
    return TC.pad_front(arr, N), back


def test_host_combines():
    for a, b in [(b"hello ", b"world"), (b"", b"x"), (b"x", b""),
                 (_rand(1000), _rand(3000)), (_rand(1000), _rand(70000))]:
        for mod, z in (("crc32", zlib.crc32), ("adler32", zlib.adler32)):
            want = z(a + b)
            args = (z(a), z(b), len(b))
            assert getattr(PC, mod + "_combine")(*args) == want
            assert getattr(TC, mod + "_combine")(*args) == want


@pytest.mark.parametrize("i", range(len(DATASETS)))
def test_crc32_device_front_and_tail(i):
    data = DATASETS[i]
    n = len(data)
    front, back = _buffers(data, TC.CRC_LANE_BYTES)
    want = zlib.crc32(data)
    assert int(TC.crc32_device(jnp.asarray(front), n)) == want
    assert int(TC.crc32_device_tail(jnp.asarray(back), n)) == want
    assert PC.crc32_device(torch.from_numpy(front), n) == want
    assert PC.crc32_device_tail(torch.from_numpy(back), n) == want


@pytest.mark.parametrize("i", range(len(DATASETS)))
def test_adler32_device_front_and_tail(i):
    data = DATASETS[i]
    n = len(data)
    front, back = _buffers(data, TC.ADLER_CHUNK)
    want = zlib.adler32(data)
    assert int(TC.adler32_device(jnp.asarray(front), n)) == want
    assert int(TC.adler32_device_tail(jnp.asarray(back), n)) == want
    assert PC.adler32_device(torch.from_numpy(front), n) == want
    assert PC.adler32_device_tail(torch.from_numpy(back), n) == want


@pytest.mark.parametrize("kind", ["crc32", "adler32"])
def test_device_streaming_with_prev(kind):
    data = _rand(50000)
    z = getattr(zlib, kind)
    m = TC.CRC_LANE_BYTES if kind == "crc32" else TC.ADLER_CHUNK
    t_state = p_state = z(b"")
    pos = 0
    for size in (7, 128, 10000, 50000 - 7 - 128 - 10000):
        piece = data[pos:pos + size]
        pos += size
        front, _ = _buffers(piece, m)
        t_state = int(getattr(TC, kind + "_device")(jnp.asarray(front),
                                                     size, t_state))
        p_state = getattr(PC, kind + "_device")(torch.from_numpy(front),
                                                size, p_state)
        assert p_state == t_state == z(data[:pos])


def test_combine_device():
    a, b = _rand(12345), _rand(54321)
    for kind, z in (("crc32", zlib.crc32), ("adler32", zlib.adler32)):
        args = (z(a), z(b), len(b))
        want = z(a + b)
        assert int(getattr(TC, kind + "_combine_device")(*args)) == want
        assert getattr(PC, kind + "_combine_device")(*args,
                                                     device="cpu") == want


def test_one_pad_size_many_lengths():
    N = 1 << 16
    for n in (0, 1, 100, 65535, 65536):
        data = _rand(n)
        arr = TC.pad_front(np.frombuffer(data, np.uint8), N)
        for kind, z in (("crc32", zlib.crc32), ("adler32", zlib.adler32)):
            t = int(getattr(TC, kind + "_device")(jnp.asarray(arr), n))
            p = getattr(PC, kind + "_device")(torch.from_numpy(arr), n)
            assert p == t == z(data), (kind, n)


def test_row_batches_match_shard_batches():
    lens = np.array([0, 1, 8191, 5000], np.int64)
    rows = np.zeros((4, 8192), np.uint8)
    for i, n in enumerate(lens):
        rows[i, :n] = np.frombuffer(_rand(int(n)), np.uint8)
    t_crc = np.asarray(TS._crc_batch(jnp.asarray(rows), lens))
    t_adl = np.asarray(TS._adler_batch(jnp.asarray(rows), lens))
    p_crc = PC.crc32_device_tail_batch(torch.from_numpy(rows), lens)
    p_adl = PC.adler32_device_tail_batch(torch.from_numpy(rows), lens)
    for i, n in enumerate(lens):
        b = rows[i, :n].tobytes()
        assert int(p_crc[i]) == int(t_crc[i]) == zlib.crc32(b)
        assert int(p_adl[i]) == int(t_adl[i]) == zlib.adler32(b)


@pytest.mark.parametrize("len2, want", [((1 << 29) + 5, 0x492D3EA7),
                                        ((1 << 30) + 7, 0xB044A3CD)])
def test_crc32_combine_device_past_2_29_bytes(len2, want):
    """tbz's device CRC holds the bit count 8·len2 in uint32, which wraps
    for len2 >= 2^29 (tbz/checksums.py:450): it returns 0xe6ee181f and
    0x315d2a04 here. The port counts bytes in 64 bits and is held to the
    host combine (zlib's algebra), not to tbz's device result."""
    host = PC.crc32_combine(0x12345678, 0x9ABCDEF0, len2)
    assert host == want
    assert PC.crc32_combine_device(0x12345678, 0x9ABCDEF0, len2,
                                   device="cpu") == want


def test_ranges_outside_the_buffer_raise():
    buf = torch.zeros(100, dtype=torch.uint8)
    with pytest.raises(ValueError):
        PC.crc32_device_tail(buf, 101)
    with pytest.raises(ValueError):
        PC.adler32_device(buf, -1)
    with pytest.raises(ValueError):
        PC.crc32_device_tail_batch(buf.view(2, 50), [10, 51])
    with pytest.raises(ValueError):
        PC.crc32_combine_device(1 << 32, 0, 5, device="cpu")
