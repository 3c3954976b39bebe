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
    return PC.pad_front(arr, N), back


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
        arr = PC.pad_front(np.frombuffer(data, np.uint8), N)
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


# --- CPU models of csrc/adler32.cu and csrc/crc32.cu -----------------------
# numpy versions of the kernels' decomposition, with the kernels'
# constants (csrc/checksum.cuh): the range [A, E) of a buffer whose index
# is the address is split into 16-byte words of [floor16(A), floor16(E))
# (word 0 with its bytes before A zeroed), spans of a grid of G blocks,
# THREADS threads a block taking words t, t + THREADS, ..., and a byte
# tail. The bytes outside the range are random, so a model that read
# them would disagree with zlib.

THREADS = 256
TARGET_BLOCKS = 4 * 132
MIN_SPAN = 256
MAX_SPAN = 1 << 20
MODEL_LENGTHS = [0, 1, 15, 16, 17, 4095, 4096, 4097, 70_001]


def _cdiv(a, b):
    return -(-a // b)


def _grid_blocks(S, max_len):
    maxw = max_len // 16 + 1
    g = min(_cdiv(TARGET_BLOCKS, S), _cdiv(maxw, MIN_SPAN))
    return max(g, _cdiv(maxw, MAX_SPAN), 1)


def _split(mem, a, n, G):
    """(words uint8[nw, 16], tail bytes, spans [(lo, hi)])."""
    p0, pt = a & ~15, (a + n) & ~15
    nw = (pt - p0) >> 4
    words = mem[p0:p0 + 16 * nw].reshape(nw, 16).copy()
    if nw:
        words[0, :a - p0] = 0          # the head: never loaded
    tail = mem[pt if nw else a:a + n]
    assert len(tail) < 16
    span = max(MIN_SPAN, _cdiv(nw, G))
    active = _cdiv(nw, span) if nw else 1
    spans = [(b * span, min(nw, (b + 1) * span)) for b in range(active)]
    return words, tail, spans


def _dp4a(x, y, c):
    """__dp4a(unsigned): c + the dot product of x's and y's four bytes."""
    x = x.astype(np.uint64)
    return c + sum(((x >> (8 * k)) & 255) * ((y >> (8 * k)) & 255)
                   for k in range(4))


def _adler_model(mem, a, n, prev, G):
    m = PC.ADLER_MOD
    words, tail, spans = _split(mem, a, n, G)
    nw = len(words)
    u = words.view("<u4").reshape(nw, 4)
    one = 0x01010101
    aw = _dp4a(u[:, 0], one, _dp4a(u[:, 1], one, _dp4a(
        u[:, 2], one, _dp4a(u[:, 3], one, np.uint64(0)))))
    ww = _dp4a(u[:, 0], 0x0D0E0F10, _dp4a(u[:, 1], 0x090A0B0C, _dp4a(
        u[:, 2], 0x05060708, _dp4a(u[:, 3], 0x01020304, np.uint64(0)))))
    assert np.array_equal(aw, words.sum(1))
    assert np.array_equal(ww, (words * np.arange(16, 0, -1)).sum(1))
    sa_all = sb_all = 0
    for lo, hi in spans:
        after = (16 * (hi - 1 - np.arange(lo, hi))).astype(np.uint64)
        assert int(after.max(initial=0)) < 1 << 32      # uint32 in the kernel
        sa = int(aw[lo:hi].sum())
        sb = int((after * aw[lo:hi] + ww[lo:hi]).sum())
        assert sb < 1 << 64
        pa = sa % m
        sa_all += pa
        sb_all += (sb % m + (16 * (nw - hi)) % m * pa) % m
    x, y = sa_all % m, sb_all % m
    for byte in tail.tolist():
        x += byte
        y += x
    a0, b0 = prev & 0xFFFF, (prev >> 16) & 0xFFFF
    return ((b0 + n % m * (a0 % m) + y) % m << 16) | ((a0 + x) % m)


def _gf2(cols, v):
    """The matrix `cols` (uint32[32]) times each uint32 of v."""
    out = np.zeros_like(v)
    for i in range(32):
        out ^= np.where((v >> np.uint32(i)) & np.uint32(1), cols[i],
                        np.uint32(0))
    return out


def _shift(v, nbytes):
    mats = PC._pow2_shift_cols()
    k = 0
    while nbytes:
        if nbytes & 1:
            v = _gf2(mats[k], v)
        nbytes >>= 1
        k += 1
    return v


def _crc_model(mem, a, n, prev, G):
    T = PC.crc_tables()
    words, tail, spans = _split(mem, a, n, G)
    nw = len(words)
    u = words.view("<u4").reshape(nw, 4)
    lw = np.zeros(nw, np.uint32)          # L(word): 16 byte steps
    for i in range(4):
        lw ^= u[:, i]
        for _ in range(4):
            lw = T[0][lw & 255] ^ (lw >> np.uint32(8))
    mats = PC._pow2_shift_cols()
    L = np.zeros(1, np.uint32)
    for lo, hi in spans:
        acc = np.zeros(THREADS, np.uint32)
        last = np.full(THREADS, -1)
        for k in range(_cdiv(hi - lo, THREADS)):
            w = lo + np.arange(THREADS) + k * THREADS
            ok = w < hi
            stepped = (T[1][acc & 255] ^ T[2][(acc >> 8) & 255]
                       ^ T[3][(acc >> 16) & 255] ^ T[4][acc >> 24]
                       ^ lw[np.minimum(w, nw - 1)])
            acc = np.where(ok, stepped, acc)
            last = np.where(ok, w, last)
        d = np.where(last >= 0, hi - 1 - last, 0)
        assert d.max() < 1 << 8                  # 8 matrices in the kernel
        for j in range(8):                       # x^(8·16·2^j) = row 4 + j
            acc = np.where((d >> j) & 1, _gf2(mats[4 + j], acc), acc)
        span_l = np.bitwise_xor.reduce(acc)
        L ^= _shift(np.array([span_l], np.uint32), 16 * (nw - hi))
    L = int(L[0])
    for byte in tail.tolist():
        L = int(T[0][(L ^ byte) & 255]) ^ (L >> 8)
    init = int(_shift(np.array([~prev & PC._MASK], np.uint32), n)[0])
    return ~(L ^ init) & PC._MASK


def _model_buffer(n, off):
    mem = _rng.integers(0, 256, off + n + 48, dtype=np.uint8)
    return mem, mem[off:off + n].tobytes()


@pytest.mark.parametrize("n", MODEL_LENGTHS)
@pytest.mark.parametrize("kind", ["crc32", "adler32"])
def test_kernel_model_every_offset(kind, n):
    """Each kernel's decomposition equals zlib at every start offset
    0-15 of an aligned buffer, from the default prev and two others."""
    model = _crc_model if kind == "crc32" else _adler_model
    z = getattr(zlib, kind)
    prevs = (0, 0xDEADBEEF, 0x5EED1234) if kind == "crc32" else \
        (1, 0x1234ABCD, 0xFFF0FFF0)
    for off in range(16):
        mem, data = _model_buffer(n, 16 + off)
        for prev in prevs:
            got = model(mem, 16 + off, n, prev, _grid_blocks(1, n))
            assert got == z(data, prev), (off, prev)


@pytest.mark.parametrize("G", [1, 2, 3, 7])
@pytest.mark.parametrize("kind", ["crc32", "adler32"])
def test_kernel_model_span_joins(kind, G):
    """Spans of many words a thread (a grid of G blocks over 70,001 and
    250,007 bytes) join in order: the stride shift of csrc/crc32.cu and
    the span weights of csrc/adler32.cu."""
    model = _crc_model if kind == "crc32" else _adler_model
    z = getattr(zlib, kind)
    for n, off in ((70_001, 5), (250_007, 0), (250_007, 11)):
        mem, data = _model_buffer(n, off)
        assert model(mem, off, n, 7, G) == z(data, 7)


def test_kernel_model_grid():
    """The grid of csrc/checksum.cuh: a 1 MiB row gets at least 132
    blocks, spans stay within [MIN_SPAN, MAX_SPAN] words, and the grid
    has room for every row's spans."""
    assert _grid_blocks(1, 1 << 20) >= 132
    for S, n in ((1, 0), (1, 1 << 20), (1, 640 << 20), (12, 32 << 20),
                 (4, 160 << 20), (1, 1 << 34), (65535, 100)):
        G = _grid_blocks(S, n)
        nw = n // 16 + 1
        span = max(MIN_SPAN, _cdiv(nw, G))
        assert span <= MAX_SPAN and _cdiv(nw, span) <= G, (S, n)


def test_adler_model_largest_span_fits_64_bits():
    """At the largest span (MAX_SPAN words of 0xFF bytes) the kernel's
    intermediates stay inside their widths: `after` in uint32, a word's
    after·a_w + w_w, a thread's and the block's sb in uint64."""
    a_w, w_w = 16 * 255, 136 * 255
    after_max = 16 * (MAX_SPAN - 1)
    assert after_max < 1 << 32
    word = after_max * a_w + w_w
    thread = sum(16 * (MAX_SPAN - 1 - (k * THREADS)) * a_w + w_w
                 for k in range(MAX_SPAN // THREADS))
    block = sum(16 * (MAX_SPAN - 1 - w) * a_w + w_w
                for w in range(MAX_SPAN))
    assert word < thread < block < 1 << 64
    # the modelled kernel at that span: every byte 0xFF, one block
    n = 16 * MAX_SPAN
    mem = np.full(n + 16, 255, np.uint8)
    assert _adler_model(mem, 0, n, 1, 1) == zlib.adler32(mem[:n].tobytes())
