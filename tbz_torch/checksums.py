"""Adler-32 and CRC-32: host oracles, combine algebra, and the device
checksums (kernels 5 and 6), the port of tbz/checksums.py.

The host half is copied from tbz. The device half computes the checksum
of a byte range of each row of a uint8 tensor, continuing from `prev`:

- CRC-32 is GF(2)-linear. With L(X) the register after X from a zero
  init, L(X || Y) = L(X)·x^(8|Y|) ⊕ L(Y), and
  crc32(X, prev) = ~(L(X) ⊕ (~prev)·x^(8|X|)). Leading zero bytes are
  free in L, so the kernel reads a range as 16-byte aligned words (the
  first with its bytes before the range as 0) and a byte tail, and
  joins words by shifts: byte tables for a fixed stride
  (`crc_tables`). Other shifts by x^(8n) go
  through 64 power matrices x^(8·2^k), so n is a 64-bit byte count
  (tbz's device CRC holds 8n in uint32 and is wrong for n >= 2^29).
- Adler-32 merges (sa, sb) pairs of consecutive pieces in order:
  sb = sb_l + len_r·sa_l + sb_r (mod 65521); leading zeros are free too.

On a CUDA tensor each wrapper launches its kernel (csrc/crc32.cu,
csrc/adler32.cu) or raises; on a CPU tensor it runs the plain PyTorch
version beside it (int64 arithmetic with masks: torch's uint32 is barely
supported on the CPU). tbz's MXU bit-matmul formulation is a TPU design
and is not ported.

Return types: the single-range functions and the combines return a
Python int (the one scalar fetched from the device); the row-batched
`*_batch` functions return an int64 tensor [S] on the rows' device.
"""

from __future__ import annotations

import functools
import zlib

import numpy as np
import torch

from . import _cuda

ADLER_MOD = 65521
CRC_POLY = 0xEDB88320  # reflected
_MASK = 0xFFFFFFFF
_NPOW = 64             # power matrices x^(8·2^k), k < 64: any int64 byte count

# --- host oracles ----------------------------------------------------------

adler32 = zlib.adler32
crc32 = zlib.crc32


# --- GF(2) algebra for CRC (host) ------------------------------------------

def _gf2_matrix_times(mat: list[int], vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_matrix_square(mat: list[int]) -> list[int]:
    return [_gf2_matrix_times(mat, m) for m in mat]


@functools.lru_cache(maxsize=None)
def _x8_matrix() -> tuple[int, ...]:
    """Matrix for multiplying by x^8 in the reflected CRC-32 domain."""
    # multiply-by-x matrix: column j -> x * x^j
    odd = [0] * 32
    odd[0] = CRC_POLY
    for i in range(1, 32):
        odd[i] = 1 << (i - 1)
    m = odd
    m = _gf2_matrix_square(m)  # x^2
    m = _gf2_matrix_square(m)  # x^4
    m = _gf2_matrix_square(m)  # x^8
    return tuple(m)


@functools.lru_cache(maxsize=None)
def _shift_matrix(nbytes: int) -> tuple[int, ...]:
    """Matrix for x^(8*nbytes) mod P (reflected domain)."""
    m = list(_x8_matrix())
    result = None
    n = nbytes
    while n:
        if n & 1:
            result = m if result is None else [
                _gf2_matrix_times(m, c) for c in result]
        n >>= 1
        m = _gf2_matrix_square(m)
    if result is None:  # nbytes == 0 -> identity
        return tuple(1 << i for i in range(32))
    return tuple(result)


def crc32_shift(crc: int, nbytes: int) -> int:
    """crc * x^(8*nbytes) mod P in the reflected domain."""
    return _gf2_matrix_times(list(_shift_matrix(nbytes)), crc)


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of concat(A,B) from crc32(A), crc32(B), len(B) — the zlib
    crc32_combine identity, used for sharded/tree checksum merges."""
    if len2 == 0:
        return crc1
    # With crc(X) = ~(L(X) ^ ~0·x^{8|X|}), the init-conditioning terms
    # cancel by linearity and the combine reduces to a pure shift+xor.
    return crc32_shift(crc1, len2) ^ crc2


def adler32_combine(a1: int, a2: int, len2: int) -> int:
    """Adler-32 of concat from the two piece checksums (zlib semantics)."""
    rem = len2 % ADLER_MOD
    s1_1, s2_1 = a1 & 0xFFFF, (a1 >> 16) & 0xFFFF
    s1_2, s2_2 = a2 & 0xFFFF, (a2 >> 16) & 0xFFFF
    s1 = (s1_1 + s1_2 - 1) % ADLER_MOD
    s2 = (s2_1 + s2_2 + rem * (s1_1 - 1)) % ADLER_MOD
    return ((s2 % ADLER_MOD) << 16) | s1


@functools.lru_cache(maxsize=None)
def crc_table() -> np.ndarray:
    """The classic 256-entry table (reference: checksums.lisp:177-193)."""
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (CRC_POLY if (c & 1) else 0)
        t[i] = c
    return t


_CRC_STRIDE = 4096  # bytes between a thread's words in csrc/crc32.cu


@functools.lru_cache(maxsize=None)
def crc_tables() -> np.ndarray:
    """uint32[5, 256], the tables of csrc/crc32.cu: row 0 is crc_table()
    (a byte step is L = T_0[(L ^ byte) & 0xFF] ^ (L >> 8)), rows 1-4
    multiply a register by x^(8·_CRC_STRIDE): row 1 + j maps byte j of
    the register."""
    t = np.zeros((5, 256), np.uint32)
    t[0] = crc_table()
    m = list(_shift_matrix(_CRC_STRIDE))
    for j in range(4):
        t[1 + j] = [_gf2_matrix_times(m, b << (8 * j)) for b in range(256)]
    return t


@functools.lru_cache(maxsize=None)
def _crc_tables_on(device: torch.device) -> torch.Tensor:
    """crc_tables() as int32[5, 256] on `device` (a constant)."""
    return torch.from_numpy(crc_tables().view(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def _pow2_shift_cols() -> np.ndarray:
    """uint32[64, 32]: row k holds the 32 columns of x^(8·2^k) mod P."""
    mats = [list(_x8_matrix())]
    for _ in range(_NPOW - 1):
        mats.append(_gf2_matrix_square(mats[-1]))
    return np.array(mats, dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _pow2_cols_on(device: torch.device) -> torch.Tensor:
    """The power matrices as int32[64, 32] on `device` (a constant)."""
    return torch.from_numpy(_pow2_shift_cols().view(np.int32)).to(device)


# --- plain PyTorch versions (CPU tensors; the card's yardstick) -------------

def _gf2_apply_plain(cols, v):
    """cols: int64[32] matrix columns; v: int64 tensor of uint32 values."""
    out = torch.zeros_like(v)
    for i in range(32):
        out ^= torch.where(((v >> i) & 1) == 1, cols[i], 0)
    return out


def _shift_plain(mats, v, nbytes: int):
    """v·x^(8·nbytes) by the set bits of the int64 byte count."""
    k = 0
    while nbytes:
        if nbytes & 1:
            v = _gf2_apply_plain(mats[k], v)
        nbytes >>= 1
        k += 1
    return v


_PLAIN_CHUNK = 256  # bytes a vectorised table step walks per chunk


def _crc32_plain(x, n: int, prev: int, mats, table):
    """CRC-32 of the n bytes `x` (uint8 tensor), continuing from prev."""
    C = _PLAIN_CHUNK
    K = max(1, -(-n // C))
    K2 = 1 << (K - 1).bit_length()
    buf = torch.zeros(K2 * C, dtype=torch.long, device=x.device)
    if n:
        buf[K2 * C - n:] = x.long()          # leading zeros are free
    chunks = buf.view(K2, C)
    lin = torch.zeros(K2, dtype=torch.long, device=x.device)
    for j in range(C):
        lin = table[(lin ^ chunks[:, j]) & 0xFF] ^ (lin >> 8)
    level = C.bit_length() - 1               # x^(8·C) = mats[log2 C]
    while lin.shape[0] > 1:
        lin = _gf2_apply_plain(mats[level], lin[0::2]) ^ lin[1::2]
        level += 1
    init = _shift_plain(mats, torch.tensor([~prev & _MASK],
                                           device=x.device), n)
    return (~(lin ^ init)) & _MASK


def _adler32_plain(x, n: int, prev: int):
    """Adler-32 of the n bytes `x`, continuing from prev."""
    m = ADLER_MOD
    v = x.long()
    w = (n - torch.arange(n, device=x.device)) % m   # weights n..1
    sa = v.sum() % m
    sb = (v * w).sum() % m
    a0, b0 = prev & 0xFFFF, (prev >> 16) & 0xFFFF
    a = (a0 + sa) % m
    b = (b0 + (n % m) * (a0 % m) + sb) % m
    return ((b << 16) | a).reshape(1)


def _crc32_rows_plain(rows, offs, lens, prevs):
    dev = rows.device
    mats = _pow2_cols_on(dev).long() & _MASK
    table = torch.from_numpy(crc_table().astype(np.int64)).to(dev)
    return torch.cat([_crc32_plain(rows[s, o:o + n], n, p, mats, table)
                      for s, (o, n, p) in enumerate(zip(offs, lens, prevs))])


def _adler32_rows_plain(rows, offs, lens, prevs):
    return torch.cat([_adler32_plain(rows[s, o:o + n], n, p)
                      for s, (o, n, p) in enumerate(zip(offs, lens, prevs))])


# --- kernel wrappers --------------------------------------------------------

def _row_params(rows, offs, lens, prevs):
    """Validate the ranges; returns (offs, lens, prevs) as int64 arrays."""
    if rows.dim() != 2 or rows.dtype != torch.uint8:
        raise ValueError("checksum rows must be a 2-D uint8 tensor")
    S, N = rows.shape
    offs, lens, prevs = (np.asarray(a, np.int64).reshape(-1)
                         for a in (offs, lens, prevs))
    if not len(offs) == len(lens) == len(prevs) == S:
        raise ValueError("one (offset, length, prev) per row")
    if S and (offs.min() < 0 or lens.min() < 0 or (offs + lens).max() > N):
        raise ValueError("checksum range outside its row")
    if S and (prevs.min() < 0 or prevs.max() > _MASK):
        raise ValueError("prev must be a uint32 value")
    return offs, lens, prevs


_PLAIN = {"crc32": _crc32_rows_plain, "adler32": _adler32_rows_plain}
_TICKETS: dict = {}


@functools.lru_cache(maxsize=256)
def _scratch_ints(S: int, max_len: int) -> int:
    """int32 words of the partials of kernels 5 and 6 (csrc/checksum.cuh's
    grid), asked of the library once a shape."""
    return int(_cuda.lib().tbz_checksum_scratch_ints(S, max_len))


def _tickets(dev, st: int):
    """int32 row tickets of kernels 5 and 6 for one stream, zeroed once:
    the last block of a row takes the ticket that wraps it back to 0
    (atomicInc), so every launch leaves them zeroed. Launches on one
    stream run in order, so they share them; another stream gets its
    own."""
    t = _TICKETS.get((dev, st))
    if t is None:
        t = _TICKETS[(dev, st)] = torch.zeros(65535, dtype=torch.int32,
                                              device=dev)
    return t


def _checksum_rows(name: str, rows, params, max_len: int):
    """Checksum `name` ("crc32" | "adler32") over rows uint8[S, N] with
    params int64[3, S] = (offset, length, prev), already validated and
    on the rows' device, and max_len = the longest range. Returns
    int64[S]. CPU rows: the plain version; CUDA rows: the kernel."""
    dev = rows.device
    S = rows.shape[0]
    if S == 0:
        return torch.empty(0, dtype=torch.long, device=dev)
    if dev.type == "cpu":
        return _PLAIN[name](rows, *params.tolist())
    if rows.shape[1] > 1 and rows.stride(1) != 1:
        raise ValueError("checksum rows must be contiguous along a row")
    if (params.device != dev or params.dtype != torch.int64
            or params.shape != (3, S) or not params.is_contiguous()):
        raise ValueError("params must be a contiguous int64[3, S] on the "
                         "rows' device")
    lib = _cuda.lib()
    # one allocation: the output, then the kernel's per-block partials
    buf = torch.empty(S + (_scratch_ints(S, max_len) + 1) // 2,
                      dtype=torch.long, device=dev)
    out = buf[:S]
    st = _cuda.stream(out)
    head = (rows.data_ptr(), rows.stride(0), S, params.data_ptr(), max_len)
    tail = (_tickets(dev, st).data_ptr(), buf.data_ptr() + 8 * S,
            out.data_ptr(), st)
    _cuda.count(name)
    if name == "crc32":
        err = lib.tbz_crc32_rows(*head, _pow2_cols_on(dev).data_ptr(),
                                 _crc_tables_on(dev).data_ptr(), *tail)
    else:
        err = lib.tbz_adler32_rows(*head, *tail)
    _cuda.check(err, name)
    return out


def _rows(name: str, rows, offs, lens, prevs):
    """Checksum `name` of rows[s, offs[s] : offs[s] + lens[s]] continuing
    from prevs[s], for each row s of a uint8[S, N] tensor (rows may be
    strided, bytes within a row contiguous). Returns int64[S] of uint32
    values.

    Kernels (CUDA tensors): csrc/crc32.cu replaces tbz/checksums.py
    _crc32_device, _crc32_device_tail, _crc_shift_dynamic_device,
    _crc_unshift_dynamic_device and tbz/parallel/shard.py _crc_batch;
    csrc/adler32.cu replaces _adler32_device, _adler32_device_tail and
    _adler_batch. Bound: bytes (each byte of the ranges read once)."""
    offs, lens, prevs = _row_params(rows, offs, lens, prevs)
    params = torch.from_numpy(np.stack([offs, lens, prevs])).to(rows.device)
    return _checksum_rows(name, rows, params, int(lens.max(initial=0)))


def _one_row(data, n: int):
    if data.dim() != 1:
        raise ValueError("expected a 1-D uint8 tensor")
    if not 0 <= n <= data.shape[0]:
        raise ValueError(f"n={n} outside a buffer of {data.shape[0]} bytes")
    return data.unsqueeze(0)


def crc32_device(data, n: int, prev: int = 0) -> int:
    """CRC-32 of the LAST n bytes of the 1-D uint8 tensor `data`,
    continuing from prev. Returns a Python int."""
    rows = _one_row(data, n)
    return int(_rows("crc32", rows, [data.shape[0] - n], [n], [prev])[0])


def crc32_device_tail(data, n: int, prev: int = 0) -> int:
    """CRC-32 of the FIRST n bytes of `data` (bytes at or past n are never
    read). Returns a Python int."""
    return int(_rows("crc32", _one_row(data, n), [0], [n], [prev])[0])


def adler32_device(data, n: int, prev: int = 1) -> int:
    """Adler-32 of the LAST n bytes of `data`, continuing from prev."""
    rows = _one_row(data, n)
    return int(_rows("adler32", rows, [data.shape[0] - n], [n], [prev])[0])


def adler32_device_tail(data, n: int, prev: int = 1) -> int:
    """Adler-32 of the FIRST n bytes of `data`, continuing from prev."""
    return int(_rows("adler32", _one_row(data, n), [0], [n], [prev])[0])


def crc32_device_tail_batch(rows, lens):
    """CRC-32 (from prev 0) of rows[s, :lens[s]] for each row of a uint8
    [S, N] tensor. Returns int64[S] on the rows' device."""
    S = rows.shape[0]
    return _rows("crc32", rows, np.zeros(S, np.int64), lens,
                 np.zeros(S, np.int64))


def adler32_device_tail_batch(rows, lens):
    """Adler-32 (from prev 1) of rows[s, :lens[s]]. Returns int64[S]."""
    S = rows.shape[0]
    return _rows("adler32", rows, np.zeros(S, np.int64), lens,
                 np.ones(S, np.int64))


def _combine_plain(kind: str, args):
    """Plain combine of args = int64[3, C] (value 1, value 2, len2)."""
    v1, v2, len2 = args
    if kind == "crc32":
        mats = _pow2_cols_on(args.device).long() & _MASK
        out = []
        for i in range(args.shape[1]):
            n = int(len2[i])   # zlib: len2 = 0 gives crc1
            out.append(_shift_plain(mats, v1[i:i + 1], n) ^ v2[i] if n
                       else v1[i:i + 1])
        return torch.cat(out)
    m = ADLER_MOD
    rem = len2 % m
    s1_1, s2_1 = v1 & 0xFFFF, (v1 >> 16) & 0xFFFF
    s1_2, s2_2 = v2 & 0xFFFF, (v2 >> 16) & 0xFFFF
    s1 = (s1_1 + s1_2 + m - 1) % m
    s2 = (s2_1 + s2_2 + rem * ((s1_1 + m - 1) % m)) % m
    return (s2 << 16) | s1


def _combine_args(v1: int, v2: int, len2: int, device):
    for v in (v1, v2):
        if not 0 <= v <= _MASK:
            raise ValueError("checksums must be uint32 values")
    if len2 < 0:
        raise ValueError("len2 must be >= 0")
    return torch.tensor([[v1], [v2], [len2]], dtype=torch.long,
                        device=torch.device(device or "cuda"))


def _combine(kind: str, args):
    """Combine each column of args = int64[3, C]; returns int64[C].

    Kernel (CUDA tensors): the one-block launch of csrc/crc32.cu or
    csrc/adler32.cu. Replaces tbz/checksums.py crc32_combine_device and
    adler32_combine_device."""
    if args.device.type == "cpu":
        return _combine_plain(kind, args)
    lib = _cuda.lib()
    out = torch.empty(args.shape[1], dtype=torch.long, device=args.device)
    args = args.contiguous()
    _cuda.require_cuda(args, out)
    if kind == "crc32":
        mats = _pow2_cols_on(args.device)
        _cuda.require_cuda(mats, out)
        _cuda.count(kind)
        err = lib.tbz_crc32_combine(args.data_ptr(), args.shape[1],
                                    mats.data_ptr(), out.data_ptr(),
                                    _cuda.stream(out))
    else:
        _cuda.count(kind)
        err = lib.tbz_adler32_combine(args.data_ptr(), args.shape[1],
                                      out.data_ptr(), _cuda.stream(out))
    _cuda.check(err, kind + " combine")
    return out


def crc32_combine_device(crc1: int, crc2: int, len2: int,
                         device=None) -> int:
    """crc32_combine on `device` (default cuda) with a 64-bit len2: the
    one-block launch of csrc/crc32.cu (tbz/checksums.py:442), or its plain
    version for device="cpu". Returns a Python int."""
    return int(_combine("crc32", _combine_args(crc1, crc2, len2, device))[0])


def adler32_combine_device(a1: int, a2: int, len2: int,
                           device=None) -> int:
    """adler32_combine on `device` (default cuda): the one-block launch of
    csrc/adler32.cu (tbz/checksums.py:455), or its plain version."""
    return int(_combine("adler32", _combine_args(a1, a2, len2, device))[0])
