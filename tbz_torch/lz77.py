"""Host LZ77 matchers for the encoder.

Two implementations behind one interface:
  - `match_greedy_numpy`: vectorized single-candidate matcher — for every
    position the most recent prior occurrence of its 3-gram (distance-
    minimal, found with a grouped sort), match lengths grown in lockstep
    vectorized rounds, then a cheap sequential emit walk with one-step
    lazy deferral. No per-position Python search loops.
  - the native C++ hash-chain lazy matcher (tbz_torch/native) — the
    zlib-class quality path used for the <= libz size target.

Output token arrays use the decoder's tape convention (dist==0 literal).
"""

from __future__ import annotations

import numpy as np

from . import constants as C

MIN_MATCH = C.MIN_MATCH
MAX_MATCH = C.MAX_MATCH
MAX_DIST = C.MAX_WINDOW


def _candidate_distances(data: np.ndarray) -> np.ndarray:
    """dist[i] = i - (latest j < i with the same 3-gram), 0 if none/too far."""
    n = len(data)
    if n < MIN_MATCH:
        return np.zeros(n, dtype=np.int32)
    g = (data[:n - 2].astype(np.int64) << 16) | (
        data[1:n - 1].astype(np.int64) << 8) | data[2:n]
    order = np.lexsort((np.arange(n - 2), g))  # sort by gram, then pos
    sg = g[order]
    prev = np.full(n - 2, -1, dtype=np.int64)
    same = sg[1:] == sg[:-1]
    prev_idx = np.where(same, order[:-1], -1)
    prev[order[1:]] = prev_idx
    dist = np.zeros(n, dtype=np.int32)
    pos = np.arange(n - 2)
    ok = prev >= 0
    d = np.where(ok, pos - prev, 0)
    d = np.where(d <= MAX_DIST, d, 0)
    dist[:n - 2] = d
    return dist


def _match_lengths(data: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Length of the match at each position for its candidate distance
    (0 where no candidate), capped at MAX_MATCH. Vectorized rounds."""
    n = len(data)
    L = np.zeros(n, dtype=np.int32)
    active = dist > 0
    idx = np.arange(n)
    k = 0
    while k < MAX_MATCH and active.any():
        a = np.nonzero(active)[0]
        i = a + k
        valid = i < n
        a = a[valid]
        i = i[valid]
        eq = data[i] == data[i - dist[a]]
        L[a[eq]] += 1
        still = np.zeros(n, dtype=bool)
        still[a[eq]] = True
        active &= still
        k += 1
    return np.where(L >= MIN_MATCH, L, 0)


def match_greedy_numpy(data: bytes | np.ndarray,
                       lazy: bool = True) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (out_len, dist, lit) token arrays (tape convention)."""
    arr = np.frombuffer(bytes(data), np.uint8) if not isinstance(
        data, np.ndarray) else data
    n = len(arr)
    dist = _candidate_distances(arr)
    L = _match_lengths(arr, dist)
    out_len: list[int] = []
    dists: list[int] = []
    lits: list[int] = []
    i = 0
    while i < n:
        l = int(L[i])
        if l >= MIN_MATCH:
            if lazy and i + 1 < n and int(L[i + 1]) > l:
                out_len.append(1)
                dists.append(0)
                lits.append(int(arr[i]))
                i += 1
                continue
            out_len.append(l)
            dists.append(int(dist[i]))
            lits.append(0)
            i += l
        else:
            out_len.append(1)
            dists.append(0)
            lits.append(int(arr[i]))
            i += 1
    return (np.array(out_len, dtype=np.int32),
            np.array(dists, dtype=np.int32),
            np.array(lits, dtype=np.int32))


def length_to_symbol(length: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Match length -> (litlen symbol 257..285, extra bit count, extra value)."""
    length = np.asarray(length)
    idx = np.searchsorted(C.LENGTH_BASE, length, side="right") - 1
    # length 258 maps to symbol 285 (0 extra), not 284+extra
    idx = np.where(length == 258, 28, idx)
    sym = 257 + idx
    extra_bits = C.LENGTH_EXTRA[idx]
    extra_val = length - C.LENGTH_BASE[idx]
    return sym, extra_bits, extra_val


def dist_to_symbol(dist: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Distance -> (dist symbol 0..29, extra bit count, extra value)."""
    dist = np.asarray(dist)
    idx = np.searchsorted(C.DIST_BASE, dist, side="right") - 1
    extra_bits = C.DIST_EXTRA[idx]
    extra_val = dist - C.DIST_BASE[idx]
    return idx, extra_bits, extra_val
