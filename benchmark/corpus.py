"""The benchmark's data: a configuration's files made from a seed, and
their payloads, written by the module of the configuration's container
format (formats/<format>.py, found by cells.format_module).

The mix is a frozen copy of `chip_smoke.py:corpus()` (text lines of
fourteen words, binary records of four int32 fields, random bytes and
byte runs, one kind drawn uniformly for each piece), with the same
piece sizes, generated in bulk with numpy instead of a Python loop.
Each file draws from its own generator, seeded with (seed, file index),
so the files are made and compressed in parallel threads and a file's
bytes do not depend on the others' sizes.
"""

from __future__ import annotations

import concurrent.futures

import numpy as np

import cells

WORDS = (b"the", b"of", b"stream", b"block", b"kernel", b"window",
         b"tensor", b"huffman", b"deflate", b"record", b"offset", b"value",
         b"index", b"table")
# each word followed by a space; a line's last space becomes "\n"
_TABLE = np.frombuffer(b"".join(w + b" " for w in WORDS), np.uint8)
_WORD_LEN = np.array([len(w) + 1 for w in WORDS], np.int64)
_WORD_AT = np.concatenate(([0], np.cumsum(_WORD_LEN)[:-1]))
# a piece's mean length: 22 words of 6.4 bytes, 12.5 records of 16
# bytes, 83.5 random bytes, a run of 151 bytes
_MEAN_PIECE = (21.5 * 6.43 + 12.5 * 16 + 83.5 + 151) / 4
_SEED_SPACE = 1 << 64


def _runs(lens: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """For pieces of `lens` items, each item's value of `starts` of its
    piece plus its place in the piece."""
    total = int(lens.sum())
    ends = np.cumsum(lens)
    return np.repeat(starts - (ends - lens), lens) + np.arange(total)


def _pieces(rng: np.random.Generator, n: int) -> tuple:
    """`n` pieces of the mix in order: (the concatenation of their
    bytes grouped by kind, each piece's start there, each piece's
    length)."""
    kinds = rng.integers(0, 4, n)
    lens = np.zeros(n, np.int64)
    parts = []

    # 0: a line of 4-39 words
    sel = np.flatnonzero(kinds == 0)
    nw = rng.integers(4, 40, len(sel))
    w = rng.integers(0, len(WORDS), int(nw.sum()))
    wl = _WORD_LEN[w]
    text = _TABLE[_runs(wl, _WORD_AT[w])]
    line_len = np.add.reduceat(wl, np.concatenate(([0], np.cumsum(nw)[:-1]))) \
        if len(sel) else np.zeros(0, np.int64)
    text[np.cumsum(line_len) - 1] = ord("\n")
    lens[sel] = line_len
    parts.append(text)

    # 1: 2-23 records (counter, value < 1000, 0x00C0FFEE, tag < 4)
    sel = np.flatnonzero(kinds == 1)
    nr = rng.integers(2, 24, len(sel))
    base = rng.integers(0, 1 << 24, len(sel))
    rec = np.empty((int(nr.sum()), 4), np.int32)
    rec[:, 0] = _runs(nr, base)
    rec[:, 1] = rng.integers(0, 1000, len(rec))
    rec[:, 2] = 0x00C0FFEE
    rec[:, 3] = rng.integers(0, 4, len(rec))
    lens[sel] = 16 * nr
    parts.append(rec.view(np.uint8).reshape(-1))

    # 2: 8-159 random bytes
    sel = np.flatnonzero(kinds == 2)
    lens[sel] = rng.integers(8, 160, len(sel))
    parts.append(rng.integers(0, 256, int(lens[sel].sum()), dtype=np.uint8))

    # 3: one byte 3-299 times
    sel = np.flatnonzero(kinds == 3)
    lens[sel] = rng.integers(3, 300, len(sel))
    parts.append(np.repeat(rng.integers(0, 256, len(sel), dtype=np.uint8),
                           lens[sel]))

    src = np.concatenate(parts)
    # each piece's start in src: its kind's offset, then its place
    # among the pieces of its kind
    kind_at = np.concatenate(([0], np.cumsum([len(p) for p in parts])[:-1]))
    starts = np.empty(n, np.int64)
    for k in range(4):
        sel = np.flatnonzero(kinds == k)
        starts[sel] = kind_at[k] + np.cumsum(lens[sel]) - lens[sel]
    return src, starts, lens


def make_file(seed: int, index: int, size: int) -> bytes:
    """`size` bytes of the mix, from the generator of (seed, index)."""
    rng = np.random.default_rng([seed % _SEED_SPACE, index])
    out, total = [], 0
    while total < size:
        n = int((size - total) / _MEAN_PIECE * 1.05) + 64
        src, starts, lens = _pieces(rng, n)
        mv = memoryview(src)
        out.extend(mv[a:a + m] for a, m in zip(starts.tolist(),
                                               lens.tolist()))
        total += int(lens.sum())
    return b"".join(out)[:size]


def make_config(cfg: dict, seed: int, threads: int = 8,
                scale: float = 1.0, fmt=None) -> tuple:
    """(datas, payloads) of a configuration's files, in its order.
    `fmt`: the module of its format (a Cell's `format`; None: this
    checkout's formats/<format>.py). `scale` shrinks every size, for
    tests on the CPU only."""
    sizes = [max(1, int(size * scale)) for _, size in cfg["files"]]
    fmt = fmt or cells.format_module(cfg["format"])

    def one(i):
        d = make_file(seed, i, sizes[i])
        return d, fmt.write(d, cfg["level"])

    # largest first, so the longest compression starts at once
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        done = dict(zip(order, pool.map(one, order)))
    return ([done[i][0] for i in range(len(sizes))],
            [done[i][1] for i in range(len(sizes))])
