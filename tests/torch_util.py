"""Seeded corpora for the tbz_torch parity tests (numpy generator only:
the same seed gives the same bytes on every run)."""

from __future__ import annotations

import functools
import gzip
import os
import re
import zlib

import numpy as np

_WORDS = [b"the", b"quick", b"brown", b"fox", b"tensor", b"kernel",
          b"deflate", b"huffman", b"window", b"stream"]


def corpus(seed: int, size: int) -> bytes:
    """Silesia-like mix: text, structured binary records, random bytes
    and byte runs."""
    rng = np.random.default_rng(seed)
    parts, total = [], 0
    while total < size:
        k = int(rng.integers(4))
        if k == 0:
            p = b" ".join(_WORDS[i] for i in rng.integers(0, len(_WORDS),
                                                          int(rng.integers(1, 60))))
        elif k == 1:
            n = int(rng.integers(1, 40))
            rec = np.zeros((n, 4), np.int32)
            rec[:, 0] = np.arange(n) + int(rng.integers(1 << 20))
            rec[:, 1] = rng.integers(0, 100, n)
            rec[:, 2] = 0x10203
            p = rec.tobytes()
        elif k == 2:
            p = rng.integers(0, 256, int(rng.integers(1, 200)),
                             dtype=np.uint8).tobytes()
        else:
            p = bytes([int(rng.integers(256))]) * int(rng.integers(1, 400))
        parts.append(p)
        total += len(p)
    return b"".join(parts)[:size]


def raw_deflate(data: bytes, level: int = 6, zdict: bytes | None = None) -> bytes:
    if zdict is None:
        c = zlib.compressobj(level, zlib.DEFLATED, -15)
    else:
        c = zlib.compressobj(level, zlib.DEFLATED, -15, 9,
                             zlib.Z_DEFAULT_STRATEGY, zdict)
    return c.compress(data) + c.flush()


# BGZF (SAMv1 §4.1): each block a gzip member of at most 65,280 bytes of
# data whose FEXTRA holds the subfield BC (SI1 66, SI2 67, SLEN 2) with
# BSIZE, the member's size less 1; a file ends with this empty block
BGZF_BLOCK = 0xFF00
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b00"
                         "03000000000000000000")


def bgzf_block(data: bytes, level: int = 6, bsize_delta: int = 0) -> bytes:
    """One BGZF member of `data` as htslib writes it (MTIME 0, XFL 0, OS
    255); `bsize_delta` makes its BSIZE lie by that many bytes."""
    body = raw_deflate(data, level)
    bsize = 18 + len(body) + 8 - 1 + bsize_delta
    return (bytes.fromhex("1f8b08040000000000ff0600") + b"BC\x02\x00"
            + bsize.to_bytes(2, "little") + body
            + (zlib.crc32(data) & 0xFFFFFFFF).to_bytes(4, "little")
            + len(data).to_bytes(4, "little"))


def bgzf(blocks, level: int = 6) -> bytes:
    """A BGZF file of one member a block of `blocks`, then the EOF
    block."""
    return b"".join(bgzf_block(b, level) for b in blocks) + BGZF_EOF


def mixed_blocks(seed: int) -> bytes:
    """Dynamic + stored + static blocks in one raw stream."""
    rng = np.random.default_rng(seed)
    co = zlib.compressobj(9, zlib.DEFLATED, -15)
    part1 = co.compress(corpus(seed, 80 << 10)) + co.flush(zlib.Z_FULL_FLUSH)
    stored = zlib.compressobj(0, zlib.DEFLATED, -15)
    part2 = stored.compress(rng.integers(0, 256, 40 << 10,
                                         dtype=np.uint8).tobytes())
    part2 += stored.flush(zlib.Z_FULL_FLUSH)
    fixed = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    part3 = fixed.compress(corpus(seed + 1, 30 << 10)) + fixed.flush()
    return part1 + part2 + part3


def short_blocks(seed: int, size: int, level: int = 6) -> bytes:
    """A raw stream of many short dynamic blocks: a Z_SYNC_FLUSH or
    Z_FULL_FLUSH after every 200-3000 input bytes (each flush ends the
    block and adds an empty stored block). Its lanes end at end-of-block
    codes, segments start in the middle of a lane run, and many lanes
    hold fewer than HEAD + TAIL = 240 symbols."""
    rng = np.random.default_rng(seed)
    data = corpus(seed, size)
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    out, pos = [], 0
    while pos < len(data):
        n = int(rng.integers(200, 3001))
        out.append(co.compress(data[pos:pos + n]))
        out.append(co.flush(zlib.Z_FULL_FLUSH if rng.integers(2)
                            else zlib.Z_SYNC_FLUSH))
        pos += n
    out.append(co.flush())
    return b"".join(out)


SCAN_CASES = ("gzip6", "zlib1", "random", "truncated_mid_header",
              "header_at_end", "stored_static", "exactly_256",
              "many_headers")


@functools.lru_cache(maxsize=1)
def scan_cases() -> dict:
    """Bodies for the header scan (ops/batched.scan_headers against
    native/loader.scan_headers): name -> raw DEFLATE bytes (or bytes
    that are not DEFLATE at all)."""
    gz6 = gzip.compress(corpus(47, 1 << 20), 6)[10:-8]
    rng = np.random.default_rng(48)
    head = raw_deflate(corpus(45, 64 << 10), 6)   # a header at bit 0
    stored = zlib.compressobj(0, zlib.DEFLATED, -15)
    fixed = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    return {
        # the benchmark corpus's mix: a gzip level-6 body, a zlib level-1
        "gzip6": gz6,
        "zlib1": zlib.compress(corpus(46, 512 << 10), 1)[2:-4],
        # many pre-filter survivors, no header
        "random": rng.integers(0, 256, 256 << 10, dtype=np.uint8).tobytes(),
        # cut 40 bytes into the second block's header (it is ~90 long)
        "truncated_mid_header": gz6[:_second_header_byte(gz6) + 40],
        # a byte-aligned header's first 2 bytes end the body: it starts
        # within 17 bits of the end, where no position is tested
        "header_at_end": gz6[:4096] + head[:2],
        "stored_static": (stored.compress(corpus(43, 60 << 10))
                          + stored.flush(zlib.Z_FULL_FLUSH)
                          + fixed.compress(corpus(44, 60 << 10))
                          + fixed.flush()),
        # exactly 256 bytes, one dynamic block
        "exactly_256": raw_deflate(corpus(49, 726), 6),
        # the first block's header (bits 0-720) 5000 times, byte-aligned:
        # 5000 candidates, past the host scan's first cap of 4096
        "many_headers": head[:91] * 5000,
    }


def _second_header_byte(body: bytes) -> int:
    """The byte in which the second dynamic block header of `body`
    starts (by the host scan)."""
    from tbz_torch.native import loader as NL
    return int(NL.scan_headers(body)[0][1]) // 8


def scan_survivors_plain(body: bytes, chunk: int = 1 << 20) -> int:
    """The positions of [0, 8 * len(body) - 17) that pass the scan's
    pre-filter, BTYPE = 10 and frontend.cc precode_plausible (HLIT and
    HDIST in range, the code-length code exactly Kraft-complete; zero
    bits past the body's end): the plain count of the survivors of
    csrc/headers.cu and of native/loader.scan_survivors, `chunk`
    positions at a time."""
    raw = np.frombuffer(body, np.uint8)
    hi = 8 * len(raw) - 17
    n = 0
    for lo in range(0, max(hi, 0), chunk):
        up = min(hi, lo + chunk)   # positions [lo, up); a header < 128 bits
        seg = np.zeros((up - lo) // 8 + 18, np.uint8)
        part = raw[lo // 8:lo // 8 + len(seg)]
        seg[:len(part)] = part
        bits = np.unpackbits(seg, bitorder="little")[lo % 8:]
        p = np.arange(up - lo)
        p = p[(bits[p + 1] == 0) & (bits[p + 2] == 1)] + 3

        def field(off, k):
            return sum(bits[p + off + t].astype(np.int64) << t
                       for t in range(k))
        p = p[(field(0, 5) <= 29) & (field(5, 5) <= 29)]
        ncl = field(10, 4) + 4
        cl = [np.where(i < ncl, field(14 + 3 * i, 3), 0) for i in range(19)]
        left = np.ones(len(p), np.int64)
        for length in range(1, 8):   # once below 0, left never comes back
            left = 2 * left - sum(c == length for c in cl)
        n += int((left == 0).sum())
    return n


def assert_same_scan(got, want, zero_tail: bool = True) -> None:
    """Two scan_headers tuples are equal: each of the five per-header
    arrays exactly (dtype too), and each header's code lengths over its
    hlit + hdist. Past them the host scan leaves its bytes undefined;
    with `zero_tail` (the kernel's tuple), `got` holds zeros there."""
    assert len(got) == len(want) == 6
    for g, w in zip(got[:5], want[:5]):
        assert g.dtype == w.dtype
        assert np.array_equal(g, w)
    g, w = got[5], want[5]
    assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
    for k, n in enumerate(got[3] + got[4]):
        assert np.array_equal(g[k, :n], w[k, :n]), k
        assert not (zero_tail and g[k, n:].any()), k


def _tape_arrays(cols, L: int, S: int):
    """[S, L] int32 lane-tape arrays (starts, packed, dist) from per-lane
    lists of (start, packed, dist); empty slots are -1 / 0 / 0."""
    st = np.full((S, L), -1, np.int32)
    pk = np.zeros((S, L), np.int32)
    ds = np.zeros((S, L), np.int32)
    for l, col in enumerate(cols):
        for s, (a, p, d) in enumerate(col[:S]):
            st[s, l], pk[s, l], ds[s, l] = a, p, d
    return st, pk, ds


def stitch_mask_tape():
    """A hand-built kernel-3 input where the merge-point mask removes a
    lane's first hit: lane 1 merges into lane 0 at m0 = 2 and emits 60
    (< HEAD + TAIL) symbols; lane 2's first unmasked hit is lane 1's
    start at tail index 0 < m0, so the stitch must take its next hit
    (lane 1's tail index 10). Returns the numpy arguments of
    _stitch_compact but `flat`: (starts, packed, dist, ok, tbl_idx,
    seg_id, seg_sym, L, S, B)."""
    L, S, B = 16, 256, 2
    lit = (1 | (65 << 9))
    chain0 = [100 + 10 * i for i in range(50)]            # 100 .. 590
    lane1 = [105, 112] + [130 + 10 * i for i in range(58)]  # merges at m=2
    lane2 = [105, 112, lane1[10]] + [lane1[10] + 7 * (i + 1)
                                     for i in range(40)]
    cols = [[(a, lit, 0) for a in chain0], [(a, lit, 0) for a in lane1],
            [(a, lit, 0) for a in lane2]]
    cols[2][-1] = (cols[2][-1][0], 1 << 17, 0)            # ends at an EOB
    cols += [[(0, lit, 0)] for _ in range(L - 3)]         # padding lanes
    st, pk, ds = _tape_arrays(cols, L, S)
    seg = np.zeros(L, np.int32)
    seg[3:] = 1
    seg_sym = np.zeros(L, np.int32)
    seg_sym[:3] = 100
    return (st, pk, ds, np.ones(L, np.int32), seg.copy(), seg, seg_sym,
            L, S, B)


def stitch_random_tape(seed: int, L: int = 64, S: int = 256):
    """A seeded synthetic kernel-3 input: segments of lanes that cover a
    true chain of increasing symbol starts with random overlaps, gaps,
    garbage prefixes, short lanes, end-of-block codes, failed lanes and
    padding lanes on segment 0 (the lane kernel's tape form: a lane's
    starts strictly increase and end at its first -1)."""
    rng = np.random.default_rng(seed)
    n_real = int(rng.integers(L // 2, L + 1))
    cols, seg, seg_sym = [], [], []
    s_id, pos = 0, 1000
    while len(cols) < n_real:
        chain = list(pos + np.cumsum(rng.integers(1, 30, 4000)))
        pos = int(chain[-1]) + 100
        at = 0
        for k in range(int(rng.integers(1, 6))):
            if len(cols) >= n_real:
                break
            if k:  # overlap (merge) or a gap past the last lane (dead)
                at = max(0, at + int(rng.integers(-150, 20)))
            n = int(rng.choice([rng.integers(1, 60), rng.integers(60, 240),
                                rng.integers(240, S + 1)]))
            g = int(rng.integers(0, 4))
            junk = sorted(set(int(chain[at]) - 1 - int(x)
                              for x in rng.integers(0, 9, g)))
            starts = [v for v in junk if v < chain[at]] + \
                [int(v) for v in chain[at:at + n]]
            starts = starts[:n]
            col = [(a, int(rng.choice([1 | (97 << 9), 3 + (a % 200)])),
                    int(rng.integers(1, 5000))) for a in starts]
            if col and rng.random() < 0.15:
                col[-1] = (col[-1][0], 1 << 17, 0)
            cols.append(col)
            seg.append(s_id)
            seg_sym.append(int(chain[0]))
            at += len(starts) - len(junk)
        s_id += 1
    while len(cols) < L:
        cols.append([(0, 1 | (65 << 9), 0)])
        seg.append(0)
        seg_sym.append(0)
    st, pk, ds = _tape_arrays(cols, L, S)
    ok = (rng.random(L) > 0.05).astype(np.int32)
    B = 1 << max(1, (s_id - 1).bit_length())
    seg = np.asarray(seg, np.int32)
    return (st, pk, ds, ok, seg.copy(), seg, np.asarray(seg_sym, np.int32),
            L, S, B)


def stitch_flat(args, device="cpu", err_seed: int = 0):
    """Kernel 3's arguments as tensors on `device` and a zeroed flat
    buffer with seeded exits and table-error words (a few candidates
    fail their table build)."""
    import torch
    st, pk, ds, ok, tbl, seg, ssym, L, S, B = args
    rng = np.random.default_rng(err_seed)
    flat = np.zeros(7 * L + 2 * B + 1 + L * S + 1, np.int32)
    flat[4 * L:5 * L] = rng.integers(0, 1 << 20, L)
    flat[7 * L:7 * L + 2 * B] = (rng.random(2 * B) < 0.1) * 4
    ts = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
          for a in (st, pk, ds, ok, tbl, seg, ssym)]
    return ts + [L, S, B, torch.from_numpy(flat).to(device)]


def bad_cl_repeat_header() -> bytes:
    """A dynamic header whose first code-length symbol is a repeat (16)
    with nothing to repeat (zlib: "invalid bit length repeat")."""
    bits = [1, 0, 1] + [0] * 14                  # BFINAL, BTYPE 2, HLIT,
    for v in (1, 0, 0, 1):                       # HDIST, HCLEN = 4: the
        bits += [(v >> k) & 1 for k in range(3)]  # codes of 16 and 0
    bits += [1] + [0] * 16                       # symbol 16 first
    out = bytearray((len(bits) + 7) // 8)
    for i, bit in enumerate(bits):
        out[i // 8] |= bit << (i % 8)
    return bytes(out)


def every_length_code(rng, n_syms: int) -> np.ndarray:
    """A complete code with every length 1-15 present: it has exactly
    16 codes (lengths 1, 2, ..., 15, 15: one of each length already
    weighs 1 - 2^-15), on random symbols."""
    lens = np.zeros(n_syms, np.int32)
    lens[rng.choice(n_syms, 16, replace=False)] = list(range(1, 16)) + [15]
    return lens


def long_code(rng, n_syms: int, n_long: int, eob: bool = False) -> np.ndarray:
    """A complete code with n_long codes of 11-15 bits (the lane kernel's
    shared-memory root covers 10 bits), completed by the short codes of
    the remaining Kraft weight's binary expansion, so decoding random
    bits takes a long code often. Litlen symbols 286-287 get no code;
    the end-of-block code (256) only when `eob`, at 15 bits."""
    syms = np.arange(min(n_syms, 286))
    if n_syms == 288:
        syms = syms[syms != 256]
    while True:
        long = sorted(rng.choice([11, 12, 13, 14, 15], n_long,
                                 p=[0.6, 0.15, 0.1, 0.05, 0.1]))
        rest = (1 << 15) - sum(1 << (15 - int(x)) for x in long)
        short = [15 - k for k in range(15) if (rest >> k) & 1]
        depths = short + [int(x) for x in long]
        if len(depths) <= len(syms) + int(eob):
            break
        n_long -= 1
    lens = np.zeros(n_syms, np.int32)
    if eob:
        i = depths.index(15) if 15 in depths else len(depths) - 1
        lens[256] = depths.pop(i)
    lens[rng.choice(syms, len(depths), replace=False)] = depths
    return lens


def adversarial_tables(seed: int):
    """Code lengths (lit int32[8, 288], dist int32[8, 32]) for kernels 1
    and 2: long codes in both alphabets (rows 0-1; row 0 has every length
    1-15), a single 1-bit code (2), over-subscribed (3) and incomplete (4)
    sets, an all-zero padded row (5), the fixed code (6) and a moderate
    random code (7). Rows 2-5 have err != 0 or decode little."""
    rng = np.random.default_rng(seed)
    lit = np.zeros((8, 288), np.int32)
    dist = np.zeros((8, 32), np.int32)
    lit[0] = every_length_code(rng, 288)
    dist[0] = long_code(rng, 32, 20)
    lit[1] = long_code(rng, 288, 250, eob=True)
    dist[1] = every_length_code(rng, 32)
    lit[2, 65] = 1
    dist[2, 3] = 1
    lit[3] = long_code(rng, 288, 200)
    lit[3, np.flatnonzero(lit[3] == 0)[:3]] = 4       # one code too many
    dist[3] = long_code(rng, 32, 12)
    dist[3, np.flatnonzero(dist[3] == 0)[:2]] = 2
    lit[4] = long_code(rng, 288, 120)
    lit[4, np.flatnonzero(lit[4])[:2]] = 0            # two leaves dropped
    dist[4] = long_code(rng, 32, 12)
    dist[4, np.flatnonzero(dist[4])[0]] = 0
    lit[6, :144], lit[6, 144:256], lit[6, 256:280], lit[6, 280:] = 8, 9, 7, 8
    dist[6] = 5
    lit[7] = complete_code(rng, 288, 250)
    dist[7] = complete_code(rng, 32, 28)
    return lit, dist


def complete_code(rng, n_syms: int, n_used: int) -> np.ndarray:
    """A random complete prefix code: leaves split at random until n_used
    symbols have codes."""
    depths = [0]
    while len(depths) < n_used:
        cand = [i for i, d in enumerate(depths) if d < 15]
        d = depths.pop(cand[int(rng.integers(len(cand)))])
        depths += [d + 1, d + 1]
    lens = np.zeros(n_syms, np.int32)
    lens[rng.choice(n_syms, n_used, replace=False)] = depths
    return lens


def adversarial_lanes(seed: int, n_tables: int, L: int, S: int,
                      nbytes: int = 1 << 14, spaced: bool = False):
    """Lane-decode inputs over random stream bytes: (data bytes,
    total_bits, tbl_idx, lane_starts, lane_ends, S). total_bits stops
    short of the data's last 20 bytes, and a few lanes start at it or up
    to 24 bits past it. Without `spaced`, tbl_idx is shuffled (runs of
    equal tables broken up) and starts and spans are random; with it,
    the speculative tier's shape: every lane on table 0, starts 2048 bits
    apart, each lane 2048 bits long (the stream grown to cover them)."""
    rng = np.random.default_rng(seed)
    if spaced:
        nbytes = max(nbytes, L * 256 + 64)
    data = rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()
    total_bits = (nbytes - 20) * 8
    if spaced:
        tbl = np.zeros(L, np.int32)
        starts = np.minimum(np.arange(L) * 2048 + int(rng.integers(0, 64)),
                            total_bits)
        ends = np.minimum(starts + 2048, total_bits)
    else:
        tbl = rng.integers(0, n_tables, L).astype(np.int32)
        tbl[:min(L, 3)] = tbl[0]                       # one short run
        starts = rng.integers(0, total_bits, L)
        ends = starts + rng.integers(0, 4000, L)
        edge = rng.choice(L, min(L, 4), replace=False)
        starts[edge] = total_bits + rng.integers(0, 25, len(edge))
        starts[edge[:1]] = total_bits
    return (data, total_bits, tbl.astype(np.int32),
            starts.astype(np.int32), ends.astype(np.int32), S)


#: the adversarial lane-decode cases (seed, L, S, spaced): shuffled
#: tables over all 8 rows of adversarial_tables with an odd L, and the
#: speculative tier's shape (B = 1: row 1, a long code) at L = 1, 7, 256
LANE_CASES = ((1, 77, 300, False), (2, 130, 200, False),
              (3, 1, 384, True), (3, 7, 384, True), (3, 256, 384, True))


def lane_case(case, device="cpu"):
    """One LANE_CASES entry as tensors on `device`: ((lit_lens,
    dist_lens), (data32, tbl_idx, lane_starts, lane_ends, total_bits,
    S)); build the tables with build_flat_table."""
    import torch
    seed, L, S, spaced = case
    lit, dist = adversarial_tables(seed)
    if spaced:
        lit, dist = lit[1:2], dist[1:2]
    data, total_bits, tbl, starts, ends, S = adversarial_lanes(
        seed, len(lit), L, S, spaced=spaced)
    buf = np.zeros(-(-len(data) // 4) * 4 + 16, np.uint8)  # stage_stream's
    buf[:len(data)] = np.frombuffer(data, np.uint8)          # 16 B of slack

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return ((up(lit), up(dist)),
            (up(buf.view("<i4")), up(tbl), up(starts), up(ends), total_bits,
             S))


def root_misses(data32, lit_tabs, dist_tabs, tbl_idx, starts, packed,
                lit_bits: int = 11, dist_bits: int = 9):
    """(lookups, misses): the table lookups of every emitted symbol of a
    lane tape ([S, L] starts and packed), and how many of them the lane
    kernel's shared roots (2^lit_bits litlen and 2^dist_bits distance
    entries) cannot answer: an entry of more bits than its root's, a long
    code or the invalid entry."""
    import torch
    emit = starts >= 0
    p = starts[emit].long()
    tb = tbl_idx.long()[None, :].expand_as(starts)[emit] << 15
    words = data32.long() & 0xFFFFFFFF

    def peek(q, n):
        w = words[q >> 5] | (words[(q >> 5) + 1] << 32)
        return (w >> (q & 31)) & ((1 << n) - 1)

    e = lit_tabs.reshape(-1).long()[tb | peek(p, 15)]
    m = ((e >> 4) & 7) == 1                       # matches
    q = p[m] + (e[m] & 0xF) + ((e[m] >> 7) & 0x1F)
    de = dist_tabs.reshape(-1).long()[tb[m] | peek(q, 15)]
    misses = int(((e & 0xF) > lit_bits).sum()
                 + ((de & 0xF) > dist_bits).sum())
    return int(e.numel() + de.numel()), misses


STORED_FLAG = 1 << 30
RESOLVE_KINDS = ("deep", "far", "stored")


def tape_bytes(ol, di, rv, inp: bytes, window: bytes = b"") -> bytes:
    """The bytes a token tape decodes to, token by token (an overlapping
    match repeats its period)."""
    out = bytearray(window)
    for o, d, v in zip(ol, di, rv):
        o, d, v = int(o), int(d), int(v)
        if d > 0:
            s = len(out) - d
            seg = out[s:s + min(d, o)]
            out += (seg * (o // len(seg) + 1))[:o]
        elif v & STORED_FLAG:
            off = v & (STORED_FLAG - 1)
            out += inp[off:off + o]
        else:
            out.append(v & 0xFF)
    return bytes(out[len(window):])


def resolve_case(kind: str, seed: int, size: int = 1 << 20):
    """A seeded adversarial token tape for the LZ77 resolve, of exactly
    `size` output bytes. Returns (TokenTape, input bytes, window bytes,
    output bytes).

    deep:   a literal, then matches of 3-6 bytes at distance 1: every
            token copies the last byte of the one before, so the deepest
            genealogy is ~size / 4.5 hops (~20 doubling passes at 1 MiB,
            near the bound ceil(log2(W + size)) + 1);
    far:    a random 32 KB preset window, then mostly matches at distance
            32768 (chains that cross into the window, one hop a 32 KB),
            some at random distances into the window or the output, and
            literals;
    stored: stored runs of 1-8 KB read from the input, with matches that
            copy from them (and from each other) and literals between."""
    from tbz_torch.tape import TokenTape
    rng = np.random.default_rng(seed)
    ol, di, rv = [], [], []
    inp, window = b"", b""
    n = 0

    def add(o, d, v):
        nonlocal n
        o = min(o, size - n)
        ol.append(o), di.append(d), rv.append(v)
        n += o

    if kind == "deep":
        add(1, 0, int(rng.integers(256)))
        while n < size:
            add(int(rng.integers(3, 7)), 1, 0)
    elif kind == "far":
        window = rng.integers(0, 256, 32768, dtype=np.uint8).tobytes()
        while n < size:
            r = rng.random()
            if r < 0.75:
                add(int(rng.integers(3, 259)), 32768, 0)
            elif r < 0.9:
                add(int(rng.integers(3, 259)),
                    int(rng.integers(1, min(n + 32768, 32768) + 1)), 0)
            else:
                add(1, 0, int(rng.integers(256)))
    elif kind == "stored":
        inp = rng.integers(0, 256, size + 8192, dtype=np.uint8).tobytes()
        pos = 0
        while n < size:
            k = int(rng.integers(1, 8193))
            add(k, 0, STORED_FLAG | pos)
            pos += k
            for _ in range(int(rng.integers(0, 6))):
                if n >= size:
                    break
                if rng.random() < 0.8:
                    add(int(rng.integers(3, 259)),
                        int(rng.integers(1, min(n, 32768) + 1)), 0)
                else:
                    add(1, 0, int(rng.integers(256)))
    else:
        raise ValueError(kind)
    tape = TokenTape.from_lists(ol, di, rv)
    return tape, inp, window, tape_bytes(ol, di, rv, inp, window)


def resolve_batch_case(seed: int, cap: int = 1 << 18):
    """A batch of five rows for the batched resolve, with very different
    depths: a deep run (half the capacity), an empty row, a far-chain row
    with a preset window that fills the capacity exactly, a stored row and
    a row of 100 literals. Returns (rows, cap), each row (TokenTape,
    input bytes, window bytes, output bytes)."""
    from tbz_torch.tape import TokenTape
    rng = np.random.default_rng(seed)
    lit = [int(b) for b in rng.integers(0, 256, 100)]
    rows = [resolve_case("deep", seed, cap // 2),
            (TokenTape.from_lists([], [], []), b"", b"", b""),
            resolve_case("far", seed + 1, cap),
            resolve_case("stored", seed + 2, cap // 4),
            (TokenTape.from_lists([1] * 100, [0] * 100, lit), b"", b"",
             bytes(lit))]
    return rows, cap


def stage_resolve_batch(rows, cap: int):
    """The batched resolve's numpy arguments for `rows`: int32[S, T]
    out_len, dist, root_val (T a power of two), n_tokens int32[S],
    total_out int64[S], inputs uint8[S, M], windows uint8[S, W]
    (right-aligned), and cap."""
    S = len(rows)
    T = 1 << max(10, (max(len(t) for t, *_ in rows) - 1).bit_length())
    M = max(1, max(len(i) for _, i, _, _ in rows))
    arr = np.zeros((3, S, T), np.int32)
    inp = np.zeros((S, M), np.uint8)
    win = np.zeros((S, 32768), np.uint8)
    for r, (t, i, w, _) in enumerate(rows):
        arr[0, r, :len(t)] = t.out_len
        arr[1, r, :len(t)] = t.dist
        arr[2, r, :len(t)] = t.root_val
        inp[r, :len(i)] = np.frombuffer(i, np.uint8)
        if w:
            win[r, 32768 - len(w):] = np.frombuffer(w, np.uint8)
    nt = np.array([len(t) for t, *_ in rows], np.int32)
    tot = np.array([t.total_out for t, *_ in rows], np.int64)
    return (*arr, nt, tot, inp, win, cap)


def deepest_chain(ol, di, n_tokens: int, cap: int) -> int:
    """The most hops from any byte of [window | cap output bytes] to its
    root, walking the parents (a match byte's parent is tstart - d +
    (q - tstart) % d, clipped to the window's first byte) in index
    order: every parent lies before its byte."""
    W = 32768
    lens = np.where(np.arange(len(ol)) < n_tokens, ol, 0).astype(np.int64)
    starts = np.cumsum(lens) - lens
    tid = np.repeat(np.arange(len(ol)), lens)
    q = np.arange(len(tid))
    tstart, d = starts[tid], np.asarray(di, np.int64)[tid]
    m = d > 0
    parent = np.arange(W + cap)
    parent[W + q[m]] = np.clip(
        tstart[m] - d[m] + (q[m] - tstart[m]) % d[m] + W, 0, W + cap - 1)
    depth = [0] * (W + cap)
    deepest = 0
    for i, p in enumerate(parent.tolist()):
        if p != i:
            depth[i] = depth[p] + 1
            deepest = max(deepest, depth[i])
    return deepest


RESOLVE_CU = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          os.pardir, "tbz_torch", "csrc", "resolve.cu")


def cu_constant(name: str, path: str = RESOLVE_CU) -> int:
    """A `constexpr int` or `int64_t` constant of a CUDA source, read from
    the source itself (the CPU cannot load the kernel library)."""
    with open(path) as f:
        m = re.search(rf"constexpr int(?:64_t)? {name} = (\d+);", f.read())
    if m is None:
        raise LookupError(f"{name} is not a constant of {path}")
    return int(m.group(1))


# resolve.cu's on-chip K7 (onchip_rows): its constants, read from it
ON_THREADS, ON_ITEMS, ONCHIP_CAP = (cu_constant(n) for n in (
    "ON_THREADS", "ON_ITEMS", "ONCHIP_CAP"))
ON_STEP = ON_THREADS * ON_ITEMS
SETTLED = 0xFFFF


def onchip_model(ol, di, rv, n_tokens: int, inp, win, cap: int):
    """resolve.cu's onchip_rows on one row, step by step: the 16-bit
    parents and 8-bit values (window parents settled at once, depth 1),
    then steps of ON_STEP bytes in order, each in rounds of Jacobi
    pointer jumping that carry hops until every byte of the step has
    taken its value and depth (saturated at 65,535) from a settled
    parent; the pass count from the deepest chain. Returns (uint8[cap],
    passes)."""
    W = 32768
    nt = max(0, min(int(n_tokens), len(ol)))
    lens = np.maximum(np.asarray(ol[:nt], np.int64), 0)
    starts = np.cumsum(lens) - lens
    total = int(lens.sum())
    lim = min(total, cap)
    par = np.arange(cap, dtype=np.int64)
    val = np.zeros(cap, np.int64)
    tid = np.repeat(np.arange(nt), lens)[:lim]
    q = np.arange(lim)
    ts, jj = starts[tid], q - starts[tid]
    d = np.asarray(di[:nt], np.int64)[tid]
    v = np.asarray(rv[:nt], np.int64)[tid]
    m = d > 0
    p = ts - d + jj % np.maximum(d, 1)
    inw = m & (p < 0)
    par[q[m & ~inw]] = p[m & ~inw]
    par[q[inw]] = SETTLED
    val[q[inw]] = np.asarray(win, np.int64)[np.maximum(p[inw] + W, 0)]
    stored = ~m & ((v & STORED_FLAG) != 0)
    off = (v & (STORED_FLAG - 1)) + jj
    inp = np.asarray(inp, np.int64)
    sb = np.where(off < len(inp), inp[np.minimum(off, max(len(inp) - 1, 0))]
                  if len(inp) else 0, 0)
    val[q[stored]] = sb[stored]
    lit = ~m & ~stored
    val[q[lit]] = v[lit] & 0xFF
    deepest = 0
    for b0 in range(0, lim, ON_STEP):
        qs = np.arange(b0, min(b0 + ON_STEP, lim))
        hop = np.zeros(ON_STEP, np.int64)
        pq = par[qs]
        ptr = pq < qs
        hop[qs[ptr] - b0] = 1
        par[qs[~ptr]] = (pq[~ptr] > qs[~ptr]).astype(np.int64)
        deepest = max(deepest, int(par[qs[~ptr]].max(initial=0)))
        live = qs[ptr]
        while len(live):
            t, h = par[live], hop[live - b0]
            ht = np.where(t < b0, 0, hop[np.maximum(t - b0, 0)])
            done = ht == 0
            dep = np.minimum(h + par[t], 0xFFFF)
            new_par = np.where(done, dep, par[t])
            new_hop = np.where(done, 0, h + ht)
            new_val = np.where(done, val[t], val[live])
            par[live], hop[live - b0], val[live] = new_par, new_hop, new_val
            deepest = max(deepest, int(dep[done].max(initial=0)))
            live = live[~done]
    return val.astype(np.uint8), 1 + max(deepest - 1, 0).bit_length()


def host_splice(tape, window: bytes = b""):
    """A splice plan (the fields of ops/fused._PlanBuilder) that takes
    every token of `tape` from the uploaded host-token rows: one range of
    kind 1. Drives the splice + resolve kernel on a hand-built tape."""
    import types
    n = len(tape)
    return types.SimpleNamespace(
        dst=[(0, 0, 1)] if n else [], n_tok=n, n_bytes=tape.total_out,
        h_ol=[np.asarray(tape.out_len, np.int32)],
        h_di=[np.asarray(tape.dist, np.int32)],
        h_rv=[np.asarray(tape.root_val, np.int32)], n_host=n)


def flat_plan_cases():
    """(name, tape, input, window, output, G, K, seg_rows) for the flat
    resolve: the deep-overlap data of test_torch_resolve_spans.py with
    tbz's defaults and two smaller G / K / seg_rows shapes (2 and 6
    segments), and the three adversarial tapes of resolve_case (256 KB)
    at the defaults."""
    from tbz_torch import reference as Ref
    data = (b"\x00" * 1000 + b"ab" * 700 + b"xyz" * 500) * 12
    body = raw_deflate(data, 9)
    tape = Ref.tokenize_host(body, 0).tape
    cases = [(f"deep_overlap_G{G}_K{K}_seg{sr}", tape, body, b"", data, G, K,
              sr) for G, K, sr in ((4096, 4, 16384), (512, 2, 256),
                                   (1024, 4, 64))]
    for i, kind in enumerate(RESOLVE_KINDS):
        t, inp, win, out = resolve_case(kind, 60 + i, 1 << 18)
        cases.append((kind, t, inp, win, out, 4096, 4, 16384))
    return cases


def checksum_edge_cases(device="cpu", seed: int = 19):
    """(name, rows, offs, lens, prevs) batches for kernels 5 and 6 whose
    ranges do not start on a 16-byte boundary: rows of an aligned [15, N]
    tensor at offsets 1-15 (long ranges and ranges inside one 16-byte
    word); a [5, N] view whose stride(0) = N + 7 is not a multiple of 16,
    so each row starts at its own alignment; and rows of very different
    lengths (0, 1, 15, 4097, a third, the whole row). Seeded random
    bytes; prevs other than the defaults on some rows."""
    import torch
    rng = np.random.default_rng(seed)
    N = 300_016

    def rand(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)
                                ).to(device)

    out = []
    for name, prev in (("crc32", 0x5EED1234), ("adler32", 0x1234ABCD)):
        dflt = 0 if name == "crc32" else 1
        offs = np.arange(1, 16)
        lens = np.where(offs % 3 == 0, 16 - offs,
                        N - 16 - 1000 * offs)          # 3 rows in one word
        lens[4] = 3                                    # offset 5, 3 bytes
        prevs = np.where(offs % 2 == 0, prev, dflt)
        out.append((name, rand(15, N), offs, lens, prevs))
        flat = rand(5 * (N + 7))
        rows = flat.as_strided((5, N), (N + 7, 1))
        out.append((name, rows, np.zeros(5, np.int64),
                    np.array([N, N - 1, 70_001, 17, 4096]),
                    np.array([dflt, prev, dflt, prev, dflt])))
        out.append((name, rand(6, N), np.zeros(6, np.int64),
                    np.array([0, 1, 15, 4097, N // 3, N]),
                    np.array([prev, dflt, prev, dflt, prev, dflt])))
    return out


def rowgather_edge_cases(device="cpu", shapes=((8192, 4096),), seed: int = 23):
    """(name, idx, tbl) inputs of copy_rows / grid_rows: row counts that
    are no multiple of a warp step (4 rows) or of a 32-row tile (N = 0,
    1, 3, 5, 33, 257); indices -1, R, 2^31 - 1 and -2^31 among valid
    ones; and, at each (N, R) of `shapes`, the aligned inputs, idx[1:]
    (4 bytes into its storage) and a table view starting 4 bytes into
    its storage, apart and together, and idx[::2] (a strided view).
    Seeded int32 tables."""
    import torch
    rng = np.random.default_rng(seed)

    def table(R, off=0):
        flat = torch.from_numpy(rng.integers(-2**31, 2**31, R * 32 + off,
                                             dtype=np.int64).astype(np.int32))
        return flat.to(device)[off:].view(R, 32)

    def index(N, R, off=0):
        v = rng.integers(0, R, N + off).astype(np.int32)
        bad = rng.random(N + off) < 0.01
        v[bad] = rng.choice(np.array([-1, R, 2**31 - 1, -2**31], np.int64),
                            int(bad.sum())).astype(np.int32)
        return torch.from_numpy(v).to(device)[off:]

    out = [(f"N={n}", index(n, 37), table(37)) for n in (0, 1, 3, 5, 33, 257)]
    out.append(("outside", torch.tensor([-1, 17, 2**31 - 1, 3, -2**31, 16],
                                        dtype=torch.int32).to(device),
                table(17)))
    for N, R in shapes:
        for io, to in ((0, 0), (1, 0), (0, 1), (1, 1)):
            out.append((f"N={N} R={R} idx+{4 * io}B tbl+{4 * to}B",
                        index(N, R, io), table(R, to)))
        out.append((f"N={N} R={R} idx[::2]", index(2 * N, R)[::2],
                    table(R)))
    return out


ROT_SPECIALS = (-33, -1, 0, 31, 32, 2**31 - 1, -2**31)


def rowgather_rot_accum_cases(device="cpu", shapes=((8192, 4096),),
                              seed: int = 31):
    """(name, idx, rot, dst, tbl) inputs of rot_rows and accum_rows (and
    of copy_rows / grid_rows on idx, tbl): N = 0, 1, 3, 5, 33, 257 and
    1001 (no multiple of a 32-row warp step); idx at -1, R, 2^31 - 1 and
    -2^31 and dst at -1, N, 2^31 - 1 and -2^31 among valid ones; rot
    drawn over all of int32 and from ROT_SPECIALS; and, at each (N, R)
    of `shapes`: the index vectors and the table as views 4 bytes into
    their storage, apart and together; all N rows into row 0; a skew
    (a tenth of the rows into row 0, a fifth into N / 256 + 1 rows); and,
    for N >= 8192, buckets of 31, 32, 33 (a pull chunk), 1024, 1025 (a
    coarse bucket, FINE_MAX rows or more), 1057 and 2100 rows (past
    PIECE) in rows 0-6. Seeded
    int32 tables over the whole range, so sums wrap mod 2^32."""
    import torch
    rng = np.random.default_rng(seed)
    BAD = np.array([-1, 2**31 - 1, -2**31], np.int64)

    def put(v, off=0):   # int32 on `device`, `off` int32s into storage
        v = np.concatenate([rng.integers(-9, 9, off), v]).astype(np.int32)
        return torch.from_numpy(v).to(device)[off:]

    def table(R, off=0):
        return put(rng.integers(-2**31, 2**31, R * 32), off).view(R, 32)

    def spoil(v, top):   # ~1% of v at -1, top, 2^31 - 1 or -2^31
        bad = rng.random(len(v)) < 0.01
        v[bad] = rng.choice(np.append(BAD, top), int(bad.sum()))
        return v

    def rots(N):
        v = rng.integers(-2**31, 2**31, N)
        sp = rng.random(N) < 0.25
        v[sp] = rng.choice(np.array(ROT_SPECIALS), int(sp.sum()))
        return v

    def case(name, N, R, idx=None, dst=None, vo=0, to=0):
        idx = spoil(rng.integers(0, R, N), R) if idx is None else idx
        dst = spoil(rng.integers(0, max(N, 1), N), N) if dst is None else dst
        return (name, put(idx, vo), put(rots(N), vo), put(dst, vo),
                table(R, to))

    out = [case(f"N={n}", n, 37) for n in (0, 1, 3, 5, 33, 257, 1001)]
    out.append(case("outside", 14, 17,
                    idx=np.array([-1, 17, 2**31 - 1, -2**31, 0, 16, 5, 5, 5,
                                  3, 3, 1, 1, 2]),
                    dst=np.array([0, 1, 2, 3, -1, 14, 2**31 - 1, -2**31,
                                  0, 0, 13, 13, 13, 5])))
    n = 7 * 37
    c = case("rot specials", n, 37)
    out.append(c[:2] + (put(np.resize(np.array(ROT_SPECIALS), n)),) + c[3:])
    for N, R in shapes:
        tag = f"N={N} R={R}"
        for vo, to in ((0, 0), (1, 0), (0, 1), (1, 1)):
            out.append(case(f"{tag} vecs+{4 * vo}B tbl+{4 * to}B", N, R,
                            vo=vo, to=to))
        out.append(case(f"{tag} all into row 0", N, R,
                        idx=rng.integers(0, R, N), dst=np.zeros(N, np.int64)))
        dst = rng.integers(0, N, N)
        k = rng.random(N)
        dst[k < 0.1] = 0
        hot = (k >= 0.1) & (k < 0.3)
        dst[hot] = rng.integers(1, N // 256 + 2, int(hot.sum()))
        out.append(case(f"{tag} skewed", N, R, dst=spoil(dst, N)))
        if N < 8192:
            continue
        dst = rng.integers(5400, N, N)
        at = 0
        for d, size in enumerate((31, 32, 33, 1024, 1025, 1057, 2100)):
            dst[at:at + size] = d
            at += size
        out.append(case(f"{tag} bucket edges", N, R,
                        dst=rng.permutation(dst)))
    return out


def rowgather_strided_inputs(device="cpu", N: int = 8192, R: int = 4096,
                             seed: int = 29) -> dict:
    """The four probes' inputs with every index vector a strided view
    (every second int32 of its storage, not contiguous): idx (1% outside
    the table), rot and dst, int32[N]; tbl a seeded int32[R, 32]."""
    import torch
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, R, 2 * N).astype(np.int32)
    idx[rng.random(2 * N) < 0.01] = -1
    vecs = {"idx": idx, "rot": rng.integers(0, 32, 2 * N),
            "dst": rng.integers(0, N, 2 * N)}
    out = {k: torch.from_numpy(v.astype(np.int32)).to(device)[::2]
           for k, v in vecs.items()}
    out["tbl"] = torch.from_numpy(rng.integers(
        -2**31, 2**31, (R, 32), dtype=np.int64).astype(np.int32)).to(device)
    return out


# csrc/rowgather.cu's constants (test_torch_rowgather.py holds the two
# equal) and CPU models of how its kernels split the rows (copy_rows and
# grid_rows), rotate them (rot_rows) and sort and sum them (accum_rows).
COPY_THREADS, COPY_U = 128, 8
GRID_ROWS, GRID_STAGES, STORE_LAG = 32, 8, 1
FINE_MAX, PIECE, MAX_NB = 1024, 2048, 8192


def _split_model(kind: str, N: int, grid: int) -> list:
    """[(row, owner)] in the order the kernel `kind` ("copy" or "grid")
    stores its rows, on a grid of `grid` blocks. copy: owner (warp, step
    base, u, g), and the lane whose index it takes by shuffle is checked
    to hold that row's index. grid: owner (block, k, slot, lane) of the
    block's k-th tile, with the ring's order checked: a tile is stored
    after its slot's mbarrier phase of parity (k // GRID_STAGES) & 1
    completed, and a slot is refilled only after the bulk store that
    read it last was waited for."""
    rows = []
    if kind == "copy":
        step, warps = 4 * COPY_U, grid * COPY_THREADS // 32
        for w in range(warps):
            for base in range(w * step, N, warps * step):
                held = {32 * j + lane: base + 32 * j + lane
                        for j in range((step + 31) // 32)
                        for lane in range(32) if 32 * j + lane < step}
                for u in range(COPY_U):
                    for g in range(4):
                        i = base + 4 * u + g
                        src = 32 * (u >> 3) + 4 * (u & 7) + g
                        assert held[src] == i
                        if i < N:
                            rows.append((i, (w, base, u, g)))
        return rows
    tiles = -(-N // GRID_ROWS)
    ahead = GRID_STAGES - STORE_LAG
    for b in range(min(grid, tiles)):
        mine = (tiles - 1 - b) // grid + 1
        fills = [0] * GRID_STAGES       # completed phases a slot
        last_store = [-1] * GRID_STAGES  # tile whose store read it last
        read_done = -1                   # stores <= this have read

        def fetch(k):
            s = k % GRID_STAGES
            assert last_store[s] <= read_done
            fills[s] += 1

        for k in range(min(ahead, mine)):
            fetch(k)
        for k in range(mine):
            s = k % GRID_STAGES
            assert fills[s] == k // GRID_STAGES + 1   # parity (k // S) & 1
            row0 = (b + k * grid) * GRID_ROWS
            for lane in range(min(GRID_ROWS, N - row0)):
                rows.append((row0 + lane, (b, k, s, lane)))
            last_store[s] = k
            read_done = k - STORE_LAG
            if k + ahead < mine:
                fetch(k + ahead)
    return rows


def _rotate_model(words: np.ndarray, s: int) -> np.ndarray:
    """rowgather.cu's rotate_row on one row of 32 words: lane q of the
    8-lane group holds words 4q..4q+3, takes the 4 words of lanes (q + a)
    & 7 and (q + a + 1) & 7 (two width-8 shuffles), shifts them left by
    2 if b & 2, then by 1 if b & 1 (s = 4a + b); returns the words the
    lanes store."""
    lanes = words.reshape(8, 4)
    a = s >> 2
    out = []
    for q in range(8):
        A, B = lanes[(q + a) & 7], lanes[(q + a + 1) & 7]
        two = bool(s & 2)
        t = [A[2] if two else A[0], A[3] if two else A[1],
             B[0] if two else A[2], B[1] if two else A[3],
             B[2] if two else B[0]]
        out += t[1:5] if s & 1 else t[0:4]
    return np.array(out, words.dtype)


def _accum_model(idx, dst, tbl, grid: int,
                 round_rows: int = FINE_MAX * MAX_NB) -> dict:
    """rowgather.cu's accum_rows replayed on numpy on a grid of `grid`
    blocks, a launch a round of `round_rows` output rows (the kernel's
    ROUND), as the C entry runs them. Returns {"out": uint32[N, 32],
    "rounds": [each round's layout, _accum_round_model's], "stores": the
    output rows stored, in order, "adds": {row: how many later pieces
    added to it}}."""
    N, R = len(idx), len(tbl)
    idx, dst = idx.astype(np.int64), dst.astype(np.int64)
    tbl = tbl.astype(np.uint32).astype(np.uint64)
    valid = (idx >= 0) & (idx < R) & (dst >= 0) & (dst < N)
    out = np.zeros((N, 32), np.uint64)
    stores, adds, rounds = [], {}, []
    for d0 in range(0, N, round_rows):
        nr = min(round_rows, N - d0)
        ok = valid & (dst >= d0) & (dst < d0 + nr)
        rounds.append(_accum_round_model(idx, dst, tbl, grid, ok, d0, nr, out,
                                         stores, adds))
    return {"out": (out & 0xFFFFFFFF).astype(np.uint32), "rounds": rounds,
            "stores": stores, "adds": adds}


def _accum_round_model(idx, dst, tbl, grid, ok, d0, nr, out, stores,
                       adds) -> dict:
    """One launch of accum_rows: the rows `ok` (dst in [d0, d0 + nr)).
    F = 2^fb as the C entry picks it; each block's tile counted by coarse
    bucket ((d - d0) >> fb), the counts added and scanned (with the
    pieces past each bucket's first PIECE rows), each block claiming a
    run of each bucket for its rows (blocks in order; within a run, rows
    in tile order), then each bucket's pieces sorted by row and pulled
    into out: piece 0 stores every row of the bucket, later pieces add to
    the rows they hold. Returns {"ent": the row numbers by position,
    "starts", "fb", "d0", "nr"}."""
    N = len(idx)
    fb = 5
    while (1 << fb) < FINE_MAX and (2 << fb) * grid <= nr:
        fb += 1
    F, NB = 1 << fb, -(-nr // (1 << fb))
    assert NB <= MAX_NB
    tile = -(-N // grid)
    tiles = [range(min(N, b * tile), min(N, b * tile + tile))
             for b in range(grid)]
    hist = [np.bincount((dst[[i for i in t if ok[i]]] - d0) >> fb,
                        minlength=NB)
            if len(t) else np.zeros(NB, np.int64) for t in tiles]
    counts = np.sum(hist, axis=0)                       # A
    starts = np.concatenate([[0], np.cumsum(counts)])   # B
    more = np.where(counts > PIECE, (counts - 1) // PIECE, 0)
    cursor = starts[:-1].copy()
    ent = np.full(N, -1, np.int64)
    for b, t in enumerate(tiles):                       # C
        base = {}
        for c in np.flatnonzero(hist[b]):
            base[c] = cursor[c]
            cursor[c] += hist[b][c]
        for i in t:
            if ok[i]:
                c = (dst[i] - d0) >> fb
                assert ent[base[c]] == -1
                ent[base[c]] = i
                base[c] += 1
    assert np.array_equal(cursor, starts[1:])
    for c in range(NB):                                 # D, E
        row0 = d0 + c * F
        rows = min(F, d0 + nr - row0)
        for k in range(1 + more[c]):
            p0 = starts[c] + k * PIECE
            piece = ent[p0:min(starts[c + 1], p0 + PIECE)]
            d = dst[piece]
            assert ((d >= row0) & (d < row0 + rows)).all()
            sums = np.zeros((rows, 32), np.uint64)
            np.add.at(sums, d - row0, tbl[idx[piece]])
            if k == 0:
                out[row0:row0 + rows] = sums
                stores += range(row0, row0 + rows)
            else:
                for j in np.unique(d - row0):
                    out[row0 + j] += sums[j]
                    adds[row0 + j] = adds.get(row0 + j, 0) + 1
    return {"ent": ent, "starts": starts, "fb": fb, "d0": d0, "nr": nr}


GATHER_DTYPES = ("int32", "uint32", "uint8")


def gather_case(dtype: str, n: int, seed: int = 29, shape=(4099,)):
    """(x, idx) for ops/gather.take1d: x int32/uint32/uint8[n] over its
    dtype's whole range, idx int32 of `shape` that reaches 40 past both
    ends (so the clamp is exercised) and hits 0 and n - 1."""
    rng = np.random.default_rng(seed + n)
    info = np.iinfo(dtype)
    x = rng.integers(info.min, int(info.max) + 1, n,
                     dtype=np.int64).astype(dtype)
    idx = rng.integers(-40, n + 40, shape).astype(np.int32)
    flat = idx.reshape(-1)
    flat[:4] = (-2 ** 31, 0, n - 1, 2 ** 31 - 1)
    return x, idx


def clamped_gather(x: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """numpy's gather of the clamped indices: take1d's and take_rows'
    answer."""
    return x[np.clip(idx, 0, x.shape[0] - 1)]
