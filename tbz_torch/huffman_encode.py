"""Huffman code construction for the encoder.

Package-merge (Larmore-Hirschberg) gives *optimal* length-limited code
lengths — at the 15-bit DEFLATE limit this matches or beats zlib's
heap-then-adjust construction, which is one of the levers for hitting
"compressed size <= libz" (BASELINE.md). Canonical code assignment is
shared with the decoder (huffman.canonical_codes).
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .huffman import canonical_codes
from .native import loader


def package_merge_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Optimal code lengths (0 for unused symbols), each <= max_len.

    freqs: nonnegative int array over the symbol alphabet. Delegates to
    the native package-merge when built (identical optimal totals; the
    numpy form below is the fallback and the differential oracle).
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    used = np.nonzero(freqs > 0)[0]
    lengths = np.zeros(len(freqs), dtype=np.int32)
    n = len(used)
    if n == 0:
        return lengths
    if n == 1:
        lengths[used[0]] = 1
        return lengths
    if (1 << max_len) < n:
        raise ValueError("alphabet too large for length limit")
    if loader.available():
        return loader.package_merge(freqs, max_len)

    # Vectorized item representation: weights vector + (items, n) uint8
    # symbol-count matrix (a symbol's final length = how many of the
    # 2(n-1) cheapest items contain it; counts <= max_len). The earlier
    # tuple-multiset form churned Python objects — 606 calls cost 0.25s
    # per 4MB encode; this is whole-matrix adds + stable argsorts.
    # Stable sort with base items listed first on weight ties keeps the
    # selection a valid nodeset; any consistent tie-break preserves the
    # optimal total cost.
    order0 = np.argsort(freqs[used], kind="stable")
    bw = freqs[used][order0]
    bs = np.zeros((n, n), np.uint8)
    bs[np.arange(n), order0] = 1
    W, S = bw, bs
    for _ in range(max_len - 1):
        k = len(W) // 2
        pw = W[0:2 * k:2] + W[1:2 * k:2]
        ps = S[0:2 * k:2] + S[1:2 * k:2]
        W = np.concatenate([bw, pw])
        S = np.concatenate([bs, ps])
        o = np.argsort(W, kind="stable")
        W, S = W[o], S[o]
    sel = S[:2 * (n - 1)].sum(axis=0, dtype=np.int64)
    lengths[used] = sel
    assert lengths[used].min() >= 1 and lengths[used].max() <= max_len
    # Kraft equality sanity: optimal lengths form a complete code.
    assert sum(1 << (max_len - l) for l in lengths[used]) == 1 << max_len
    return lengths


def codes_from_lengths(lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(codes, lens) arrays over the full alphabet (0 where unused)."""
    syms, lens, codes = canonical_codes(np.asarray(lengths, dtype=np.int64))
    out_codes = np.zeros(len(lengths), dtype=np.int64)
    out_lens = np.zeros(len(lengths), dtype=np.int64)
    out_codes[syms] = codes
    out_lens[syms] = lens
    return out_codes, out_lens


def encode_code_lengths(lens: np.ndarray) -> list[tuple[int, int, int]]:
    """RFC 1951 §3.2.7 run-length encoding of a code-length sequence.

    Returns [(cl_symbol, extra_bits_count, extra_value), ...] using
    16 (copy prev 3-6), 17 (3-10 zeros), 18 (11-138 zeros).
    """
    out: list[tuple[int, int, int]] = []
    lens = [int(x) for x in lens]
    i = 0
    n = len(lens)
    prev = -1
    while i < n:
        v = lens[i]
        run = 1
        while i + run < n and lens[i + run] == v:
            run += 1
        if v == 0:
            r = run
            while r >= 11:
                take = min(r, 138)
                out.append((18, 7, take - 11))
                r -= take
            while r >= 3:
                take = min(r, 10)
                out.append((17, 3, take - 3))
                r -= take
            for _ in range(r):
                out.append((0, 0, 0))
        else:
            r = run
            if v != prev:
                out.append((v, 0, 0))
                r -= 1
            while r >= 3:
                take = min(r, 6)
                out.append((16, 2, take - 3))
                r -= take
            for _ in range(r):
                out.append((v, 0, 0))
        prev = v
        i += run
    return out


def build_dynamic_header(lit_lens: np.ndarray,
                         dist_lens: np.ndarray):
    """Plan a dynamic-block header.

    Returns (hlit, hdist, hclen, cl_lens, cl_codes, cl_stream, bit_cost)
    where cl_stream is the encode_code_lengths output for the trimmed
    lens arrays and bit_cost the exact header size in bits (after the
    3 block-header bits).
    """
    hlit = max(257, int(np.max(np.nonzero(lit_lens)[0])) + 1
               if np.any(lit_lens) else 257)
    hdist = max(1, int(np.max(np.nonzero(dist_lens)[0])) + 1
                if np.any(dist_lens) else 1)
    seq = np.concatenate([lit_lens[:hlit], dist_lens[:hdist]])
    cl_stream = encode_code_lengths(seq)
    cl_freqs = np.zeros(19, dtype=np.int64)
    for sym, _, _ in cl_stream:
        cl_freqs[sym] += 1
    cl_lens = package_merge_lengths(cl_freqs, 7)
    cl_codes, cl_lens_arr = codes_from_lengths(cl_lens)
    order = C.CODE_LENGTH_ORDER
    used_pos = [i for i in range(19) if cl_lens[order[i]] > 0]
    hclen = max(4, (used_pos[-1] + 1) if used_pos else 4)
    bit_cost = 5 + 5 + 4 + 3 * hclen + sum(
        int(cl_lens_arr[sym]) + eb for sym, eb, _ in cl_stream)
    return hlit, hdist, hclen, cl_lens_arr, cl_codes, cl_stream, bit_cost
