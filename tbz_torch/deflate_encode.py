"""DEFLATE encoder: LZ77 tokens -> optimal-Huffman blocks -> framed bytes
(tbz/deflate_encode.py's copy; host code, as it is in tbz).

The reference has no encoder (SURVEY §0); this is the north-star
extension. Per block the encoder computes exact bit costs for stored /
static / dynamic representations and emits the cheapest (zlib's
strategy, with package-merge-optimal length-limited codes giving a small
edge toward the "<= libz size" target). The native library
(native/frontend.cc) carries the matchers, package-merge, the block
planner and the token packer; where it did not build, the numpy matcher
and the Python emitter give valid but larger streams, as in tbz.
"""

from __future__ import annotations

import zlib as _zlib

import numpy as np

from . import constants as C
from . import huffman_encode as he
from . import lz77
from .bitwriter import BitWriter
from .native import loader

_STATIC_LIT_LENS = C.FIXED_LITLEN_LENGTHS
_STATIC_DIST_LENS = C.FIXED_DIST_LENGTHS


# level -> (max_chain, iters, nice_len) for the cost-model DP parse;
# levels 1-3 use the greedy/lazy hash-chain matcher (speed tier).
# nice_len stops a candidate walk once a match that long is found
# (speed; 258 = never stop early).
_OPTIMAL_CFG = {4: (32, 1, 48), 5: (64, 1, 96), 6: (160, 1, 160),
                7: (384, 2, 258), 8: (512, 3, 258), 9: (2048, 3, 258)}

# Speed tiers (levels 4-9): a lighter parse runs first and is accepted
# only if it still beats libz at the same level on the SAME data (the
# guard re-compresses with zlib — a few % of our encode time); the
# heavy _OPTIMAL_CFG parse is the fallback, so the strict <=libz
# invariant holds by construction. Tier parameters swept with the guard
# in place on the bench mix (round 3 for L6; round 4 for the rest):
# the L9 tier is ~4x the heavy parse at +0.8% size — still ~8% under
# libz — and the guard reruns heavy only where the tier loses.
# 4th element: sparse DP relax (short lengths + breakpoint tops only —
# safe under the guard; the dense relax is the fallback's job)
_FAST_TIERS = {4: (16, 1, 32, True), 5: (24, 1, 48, True),
               6: (16, 1, 48, True), 7: (96, 1, 128, True),
               8: (128, 1, 160, True), 9: (160, 1, 160, True)}
_FAST_MIN = 1 << 16


def _cap_match_distances(ol, di, li, raw: bytes, cap: int):
    """Rewrite any match whose distance exceeds `cap` (a sub-32KB
    window, zlib wbits 9..14) into its literal bytes. Correctness-first:
    the DP parse is still run at the full window, then clamped — the
    ratio cost only applies to reduced-window callers."""
    bad = di > cap
    if not bad.any():
        return ol, di, li
    end = np.cumsum(ol.astype(np.int64))
    start = end - ol
    reps = np.where(bad, ol, 1).astype(np.int64)
    idx = np.repeat(np.arange(len(ol), dtype=np.int64), reps)
    off = (np.arange(int(reps.sum()), dtype=np.int64)
           - np.repeat(np.cumsum(reps) - reps, reps))
    bad_i = bad[idx]
    ol2 = np.where(bad_i, 1, ol[idx]).astype(np.int32)
    di2 = np.where(bad_i, 0, di[idx]).astype(np.int32)
    arr = np.frombuffer(raw, np.uint8)
    li2 = np.where(bad_i, arr[start[idx] + off],
                   li[idx]).astype(np.int32)
    return ol2, di2, li2


def tokenize_for_encode(data: bytes, level: int, _cfg=None,
                        zdict: bytes = b"", max_dist: int = 32768):
    """Run the best available matcher. Returns (out_len, dist, lit).

    Levels 4-9 use the native cost-model DP parse (globally cheapest
    tokenization under iterated entropy stats — the mechanism by which
    output stays <= libz at every level on every corpus); levels 1-3 the
    lazy hash-chain matcher. _cfg overrides the level's DP parameters
    (the L6 fast/heavy tiers).

    zdict: preset dictionary — the matcher runs over dict+data and the
    dictionary-prefix tokens are trimmed (a match straddling the
    boundary is patched with literals for its data-side bytes, <=258B
    of ratio cost); emitted distances may reach into the dictionary,
    valid for any decoder preloaded with it (RFC 1950 FDICT)."""
    if zdict:
        d = bytes(zdict)[-32768:]
        ol, di, li = tokenize_for_encode(d + data, level, _cfg,
                                         max_dist=max_dist)
        end = np.cumsum(ol.astype(np.int64))
        start = end - ol
        cut = len(d)
        keep = start >= cut
        if keep.all() or not len(ol):
            return ol, di, li
        first = int(np.argmax(keep)) if keep.any() else len(ol)
        patch_n = 0
        if first > 0:
            prev_end = int(end[first - 1])
            patch_n = prev_end - cut if prev_end > cut else 0
        ol2 = np.concatenate([np.ones(patch_n, np.int32), ol[first:]])
        di2 = np.concatenate([np.zeros(patch_n, np.int32), di[first:]])
        li2 = np.concatenate([
            np.frombuffer(data[:patch_n], np.uint8).astype(np.int32),
            li[first:]])
        return ol2, di2, li2
    if not loader.available():
        res = lz77.match_greedy_numpy(data, lazy=level >= 4)
    elif _cfg is not None:
        chain, iters, nice, *sp = _cfg
        res = loader.lz77_match_optimal(data, chain, iters, nice,
                                        sparse=bool(sp and sp[0]))
    elif level in _OPTIMAL_CFG:
        chain, iters, nice = _OPTIMAL_CFG[level]
        res = loader.lz77_match_optimal(data, chain, iters, nice)
    else:
        res = loader.lz77_match(data, level)
    if max_dist < 32768:
        res = _cap_match_distances(*res, data, max_dist)
    return res


def _block_symbol_cost(lit_freqs, lit_lens, dist_freqs, dist_lens,
                       len_extra_total, dist_extra_total) -> int:
    lit_cost = int(np.sum(lit_freqs * lit_lens))
    dist_cost = int(np.sum(dist_freqs * dist_lens))
    return lit_cost + dist_cost + len_extra_total + dist_extra_total


_SPLIT_UNIT = 512  # tokens per split-plan unit


def _ent_rows(M: np.ndarray) -> np.ndarray:
    """Row-wise entropy bits of a (U, S) histogram matrix:
    n*log2(n) - sum(f*log2(f))."""
    Mf = M.astype(np.float64)
    n = Mf.sum(axis=1)
    xlogx = np.zeros_like(Mf)
    np.log2(Mf, where=Mf > 0, out=xlogx)
    xlogx *= Mf
    nl = np.zeros_like(n)
    np.log2(n, where=n > 0, out=nl)
    return n * nl - xlogx.sum(axis=1)


def _cost_rows(LF, DF, EX) -> np.ndarray:
    """Approximate dynamic-block bits a row: symbol entropy + extra bits
    + a header estimate (used only for split decisions; emission
    recomputes exact package-merge costs)."""
    hdr = 80.0 + 4.0 * ((LF > 0).sum(axis=1) + (DF > 0).sum(axis=1))
    return _ent_rows(LF) + _ent_rows(DF) + EX + hdr + 3


def _plan_blocks(ol, di, li):
    """Cost-aware block split: unit histograms + greedy pairwise merge.
    Content with drifting statistics (e.g. concatenated heterogeneous
    segments) needs adaptive boundaries — a fixed token count per block
    measured up to 4% over libz on mixed corpora. Returns [(start,
    end)] token ranges.

    Fully vectorized (was 18% of L6 encode time as per-unit Python):
    one histogram matrix built with flat bincounts, merge passes as
    whole-array entropy evaluations + a boolean left-to-right sweep."""
    n = len(ol)
    if n <= 2 * _SPLIT_UNIT:
        return [(0, n)]
    if loader.available():
        plan = loader.plan_blocks(ol, di, li, _SPLIT_UNIT)
        if plan is not None:
            return plan
    U = -(-n // _SPLIT_UNIT)
    ids = np.arange(n, dtype=np.int64) // _SPLIT_UNIT
    m = di == 0
    lsym, leb, _ = lz77.length_to_symbol(ol[~m])
    dsym, deb, _ = lz77.dist_to_symbol(di[~m])
    sym_l = np.empty(n, np.int64)
    sym_l[m] = li[m]
    sym_l[~m] = lsym
    LF = np.bincount(ids * 288 + sym_l,
                     minlength=U * 288).reshape(U, 288)
    DF = np.bincount(ids[~m] * 30 + dsym,
                     minlength=U * 30).reshape(U, 30)
    EX = (np.bincount(ids[~m], weights=(leb + deb).astype(np.float64),
                      minlength=U)
          if len(dsym) else np.zeros(U))
    starts = np.arange(U, dtype=np.int64) * _SPLIT_UNIT
    ends = np.minimum(starts + _SPLIT_UNIT, n)
    C_ = _cost_rows(LF, DF, EX)

    def pair_costs(idx):
        return _cost_rows(LF[idx] + LF[idx + 1], DF[idx] + DF[idx + 1],
                          EX[idx] + EX[idx + 1])

    # incremental fixpoint: a pass's merges only dirty the pairs
    # adjacent to a merge — recomputing every pair cost each pass was
    # O(passes * U * 288) and measured 0.42s/4MB; now ~2 full passes
    # equivalent
    MC = pair_costs(np.arange(len(starts) - 1)) if len(starts) > 1 \
        else np.empty(0)
    while len(starts) > 1:
        cond = MC <= C_[:-1] + C_[1:]
        keep_start = []
        merged = []
        i = 0
        Un = len(starts)
        changed = False
        while i < Un:
            if i + 1 < Un and cond[i]:
                keep_start.append(i)
                merged.append(True)
                i += 2
                changed = True
            else:
                keep_start.append(i)
                merged.append(False)
                i += 1
        if not changed:
            break
        ki = np.asarray(keep_start, np.int64)
        mg = np.asarray(merged, bool)
        nLF = LF[ki].copy()
        nDF = DF[ki].copy()
        nEX = EX[ki].copy()
        nC = C_[ki].copy()
        nEnds = ends[ki].copy()
        mi = ki[mg]
        nLF[mg] = LF[mi] + LF[mi + 1]
        nDF[mg] = DF[mi] + DF[mi + 1]
        nEX[mg] = EX[mi] + EX[mi + 1]
        nC[mg] = MC[mi]
        nEnds[mg] = ends[mi + 1]
        LF, DF, EX, C_ = nLF, nDF, nEX, nC
        starts, ends = starts[ki], nEnds
        if len(starts) <= 1:
            break
        # carry clean pair costs; recompute only pairs whose either
        # side was rebuilt by a merge
        nMC = MC[ki[:-1]]
        dirty = mg[:-1] | mg[1:]
        if dirty.any():
            didx = np.flatnonzero(dirty)
            nMC[didx] = pair_costs(didx)
        MC = nMC
    return list(zip(starts.tolist(), ends.tolist()))


def _emit_tokens(w: BitWriter, ol, di, li, lit_codes, lit_lens,
                 dist_codes, dist_lens) -> None:
    if loader.available():
        # Pre-reverse codes (vectorized); C++ packs LSB-first.
        nz_l = np.maximum(lit_lens, 1)
        lcr = C.bit_reverse_array(lit_codes.astype(np.int64), nz_l)
        nz_d = np.maximum(dist_lens[:30], 1)
        dcr = C.bit_reverse_array(dist_codes[:30].astype(np.int64), nz_d)
        packed, fb, fn = loader.pack_tokens(
            ol, di, li, lcr, lit_lens, dcr, dist_lens[:30], True,
            w.buf, w.nbits)
        w.out += packed
        w.buf, w.nbits = fb, fn
        return
    lsym, leb, lev = lz77.length_to_symbol(ol)
    dsym, deb, dev = lz77.dist_to_symbol(np.maximum(di, 1))
    for i in range(len(ol)):
        if di[i] == 0:
            s = int(li[i])
            w.huff(int(lit_codes[s]), int(lit_lens[s]))
        else:
            s = int(lsym[i])
            w.huff(int(lit_codes[s]), int(lit_lens[s]))
            if leb[i]:
                w.bits(int(lev[i]), int(leb[i]))
            ds = int(dsym[i])
            w.huff(int(dist_codes[ds]), int(dist_lens[ds]))
            if deb[i]:
                w.bits(int(dev[i]), int(deb[i]))
    w.huff(int(lit_codes[256]), int(lit_lens[256]))


def _emit_stored(w: BitWriter, chunk: bytes, final: bool) -> None:
    n = len(chunk)
    off = 0
    while True:
        take = min(n - off, 65535)
        last_piece = off + take == n
        w.bits(1 if (final and last_piece) else 0, 1)
        w.bits(C.BTYPE_STORED, 2)
        w.align()
        w.bits(take, 16)
        w.bits(~take & 0xFFFF, 16)
        w.raw_bytes(chunk[off:off + take])
        off += take
        if last_piece:
            break


def deflate_raw(data: bytes, level: int = 6, *, final: bool = True,
                writer: BitWriter | None = None,
                zdict: bytes = b"", max_dist: int = 32768,
                _cfg=None) -> bytes:
    """Raw DEFLATE stream (RFC 1951) of `data`.

    final=False emits non-final blocks followed by an empty stored block
    (a zlib Z_FULL_FLUSH sync point) so segments concatenate at byte
    boundaries — the streaming Compressor's chunk primitive.

    At levels 4-9 (one-shot form only — a shared `writer` cannot
    rewind) a lighter parse runs first and is kept only if it beats
    libz at the same level on this data; otherwise the heavy parse
    result is used (see _FAST_TIERS — the strict <=libz guarantee
    never depends on the fast path).
    """
    data = bytes(data)
    if (_cfg is None and writer is None and level in _FAST_TIERS
            and max_dist >= 32768 and len(data) >= _FAST_MIN):
        # the libz guard runs concurrently with the fast parse: both
        # sides release the GIL (zlib C / ctypes matcher)
        import concurrent.futures as _cf
        with _cf.ThreadPoolExecutor(1) as ex:
            if zdict:
                def _guard():
                    co = _zlib.compressobj(level, 8, -15, 8, 0,
                                           bytes(zdict))
                    return len(co.compress(data) + co.flush())
                gf = ex.submit(_guard)
            else:
                gf = ex.submit(
                    lambda: len(_zlib.compress(data, level)) - 6)
            fast = deflate_raw(data, level, final=final, zdict=zdict,
                               _cfg=_FAST_TIERS[level])
            guard = gf.result()
        if len(fast) <= guard:
            return fast
        heavy = deflate_raw(data, level, final=final, zdict=zdict,
                            _cfg=_OPTIMAL_CFG[level])
        return heavy if len(heavy) < len(fast) else fast
    w = writer or BitWriter()

    def finish():
        if not final:
            # sync point: empty non-final stored block, byte-aligns.
            w.bits(0, 1)
            w.bits(C.BTYPE_STORED, 2)
            w.align()
            w.bits(0, 16)
            w.bits(0xFFFF, 16)
        return b"" if writer is not None else w.bytes()

    if len(data) == 0:
        if final:
            # Static block containing only end-of-block.
            w.bits(1, 1)
            w.bits(C.BTYPE_STATIC, 2)
            w.huff(0, 7)  # symbol 256 in the fixed code
            return b"" if writer is not None else w.bytes()
        return finish()
    if level == 0:
        if final:
            _emit_stored(w, data, final=True)
            return b"" if writer is not None else w.bytes()
        _emit_stored(w, data, final=False)
        return finish()

    ol, di, li = tokenize_for_encode(data, level, _cfg, zdict,
                                     max_dist=max_dist)
    n_tok = len(ol)
    byte_pos = np.concatenate([[0], np.cumsum(ol)])
    blocks = _plan_blocks(ol, di, li)
    for bi, bj in blocks:
        block_final = final and bj == n_tok
        bol, bdi, bli = ol[bi:bj], di[bi:bj], li[bi:bj]
        block_bytes = data[int(byte_pos[bi]):int(byte_pos[bj])]

        # Histogram (bincount: vectorized C).
        is_lit = bdi == 0
        lsym, leb, _ = lz77.length_to_symbol(bol[~is_lit])
        dsym, deb, _ = lz77.dist_to_symbol(bdi[~is_lit])
        lit_freqs = (np.bincount(bli[is_lit], minlength=288)
                     + np.bincount(lsym, minlength=288)).astype(np.int64)
        dist_freqs = np.bincount(dsym, minlength=30).astype(np.int64)
        lit_freqs[256] += 1
        len_extra_total = int(np.sum(leb))
        dist_extra_total = int(np.sum(deb))

        # Dynamic plan.
        dyn_lit_lens = he.package_merge_lengths(lit_freqs, 15)
        dyn_dist_lens = he.package_merge_lengths(dist_freqs, 15)
        (hlit, hdist, hclen, cl_lens, cl_codes, cl_stream,
         hdr_cost) = he.build_dynamic_header(dyn_lit_lens, dyn_dist_lens)
        dyn_cost = hdr_cost + _block_symbol_cost(
            lit_freqs, dyn_lit_lens, dist_freqs, dyn_dist_lens,
            len_extra_total, dist_extra_total)
        static_cost = _block_symbol_cost(
            lit_freqs, _STATIC_LIT_LENS, dist_freqs[:30],
            _STATIC_DIST_LENS[:30], len_extra_total, dist_extra_total)
        n_chunks = max(1, -(-len(block_bytes) // 65535))
        stored_cost = 7 + 35 * n_chunks + 8 * len(block_bytes)

        if stored_cost < min(dyn_cost, static_cost):
            _emit_stored(w, block_bytes, block_final)
            continue
        w.bits(1 if block_final else 0, 1)
        if static_cost <= dyn_cost:
            w.bits(C.BTYPE_STATIC, 2)
            lit_codes, lit_lens_a = he.codes_from_lengths(_STATIC_LIT_LENS)
            dist_codes, dist_lens_a = he.codes_from_lengths(_STATIC_DIST_LENS)
        else:
            w.bits(C.BTYPE_DYNAMIC, 2)
            w.bits(hlit - 257, 5)
            w.bits(hdist - 1, 5)
            w.bits(hclen - 4, 4)
            for i in range(hclen):
                w.bits(int(cl_lens[C.CODE_LENGTH_ORDER[i]]), 3)
            for sym, eb, ev in cl_stream:
                w.huff(int(cl_codes[sym]), int(cl_lens[sym]))
                if eb:
                    w.bits(ev, eb)
            lit_codes, lit_lens_a = he.codes_from_lengths(dyn_lit_lens)
            dist_codes, dist_lens_a = he.codes_from_lengths(dyn_dist_lens)
        _emit_tokens(w, bol, bdi, bli, lit_codes, lit_lens_a,
                     dist_codes, dist_lens_a)
    return finish()


def _par_segment(args):
    idx, seg, level, last = args
    return deflate_raw(seg, level, final=last)


def deflate_raw_parallel(data: bytes, level: int = 6,
                         threads: int = 4,
                         segment: int = 1 << 20,
                         executor: str = "thread") -> bytes:
    """Segment-parallel deflate: independent segments joined at
    sync-flush points (no cross-segment references — a small ratio cost
    for near-linear thread scaling; the dp axis of encode).

    executor='process' forks worker processes: the Python half of the
    encoder (planning, Huffman, emission) holds the GIL, capping thread
    scaling at ~2x; processes scale it all. Uses the fork context: the
    children run host code only and must never touch the card (a forked
    child cannot use a CUDA context its parent created), and fork is only
    safe while the parent has no CUDA runtime threads, so callers that
    already initialized CUDA stay with 'thread', the default."""
    data = bytes(data)
    if len(data) <= segment:
        return deflate_raw(data, level)
    import concurrent.futures
    segs = [data[i:i + segment] for i in range(0, len(data), segment)]
    work = [(i, s, level, i == len(segs) - 1) for i, s in enumerate(segs)]
    if executor == "process":
        import multiprocessing as mp
        with concurrent.futures.ProcessPoolExecutor(
                threads, mp_context=mp.get_context("fork")) as ex:
            parts = list(ex.map(_par_segment, work))
    else:
        with concurrent.futures.ThreadPoolExecutor(threads) as ex:
            parts = list(ex.map(_par_segment, work))
    return b"".join(parts)


def compress(data, format: str = "zlib", level: int = 6,
             mtime: int = 0, name: str | None = None,
             extra: list | None = None,
             threads: int | None = None,
             zdict: bytes = b"", wbits: int = 15) -> bytes:
    """Compress to raw / zlib / gzip framing. threads>1 enables
    segment-parallel encoding for large inputs. extra: gzip FEXTRA
    subfields as [(2-byte id, payload), ...] (RFC 1952 §2.3.1.1).
    zdict: preset dictionary (raw/zlib only; zlib sets FDICT+DICTID).
    wbits 9..14 requests a reduced LZ77 window: match distances are
    capped at 1<<wbits and the zlib CMF carries the matching CINFO, so
    a decoder allocating only the advertised window accepts the stream
    (RFC 1950 §2.2)."""
    data = bytes(data)
    if not 9 <= wbits <= 15:
        raise ValueError(f"wbits must be 9..15, got {wbits}")
    if zdict and format == "gzip":
        raise ValueError("gzip has no preset-dictionary concept")
    max_dist = 1 << wbits
    if threads and threads > 1 and len(data) > (1 << 21) and not zdict \
            and wbits == 15:
        body = deflate_raw_parallel(data, level, threads)
    else:
        body = deflate_raw(data, level, zdict=zdict, max_dist=max_dist)
    if format == "raw":
        return body
    if format == "zlib":
        cmf = 0x08 | ((wbits - 8) << 4)  # CM=8, CINFO=wbits-8
        flevel = 0 if level < 2 else 1 if level < 6 else 2 if level < 8 else 3
        flg = (flevel << 6) | (0x20 if zdict else 0)
        rem = ((cmf << 8) | flg) % 31
        if rem:
            flg += 31 - rem
        dictid = (_zlib.adler32(bytes(zdict)).to_bytes(4, "big")
                  if zdict else b"")
        return (bytes([cmf, flg]) + dictid + body
                + _zlib.adler32(data).to_bytes(4, "big"))
    if format == "gzip":
        flg = 0
        name_b = b""
        extra_b = b""
        if extra:
            from .formats.gzip_fmt import build_extra_subfields
            blob = build_extra_subfields(extra)
            flg |= 0x04
            extra_b = len(blob).to_bytes(2, "little") + blob
        if name is not None:
            flg |= 0x08
            name_b = name.encode("utf-8") + b"\x00"
        xfl = 2 if level >= 8 else 4 if level <= 2 else 0
        hdr = (b"\x1f\x8b\x08" + bytes([flg])
               + int(mtime).to_bytes(4, "little") + bytes([xfl, 3]))
        trailer = (_zlib.crc32(data).to_bytes(4, "little")
                   + (len(data) % (1 << 32)).to_bytes(4, "little"))
        return hdr + extra_b + name_b + body + trailer
    raise ValueError(f"unknown format {format!r}")
