"""Batched multi-block speculative decode: the whole stream in ONE
device pass (kernels 1-3), feeding the meta-only host chain walk.

The port of tbz/ops/batched.py. The native header scanner
(frontend.cc tbz_scan_headers) finds every plausible dynamic block
header up front, so all blocks' tables and lane plans ship to the
device together:

  1. HOST   scan_headers -> candidate headers (true headers always
            found; rare false positives culled by the chain walk).
  2. DEVICE kernel 1 builds all B candidates' flat tables
            (ops/tokenize_device.build_flat_table); kernel 2 decodes all
            lanes of all segments in lockstep (_lanes_multi); kernel 3
            stitches lanes and compacts the tokens (_stitch_compact).
  3. HOST   chain walk over blocks, driven by METADATA ONLY (per-lane
            merge flags / offsets / exits): splice compacted segment
            tokens, gap-decode any unsynced/unscanned span with the
            native sequential decoder (correctness never depends on
            speculation), validate distances per block.

The walk needs no token values: ops/fused.decode_stream_fused fetches
only the metadata header, and the compacted tokens never leave the
device. tokenize_stream_batched (the device frontend's tier for streams
of 64 KB and more) fetches the compacted tokens too and splices a host
tape. Each kernel wrapper launches its CUDA kernel for CUDA tensors and
runs its plain PyTorch version for CPU tensors.

Lane outputs are slot-major ([S, L], lane fastest) in both versions, so
that a warp's stores at one step are coalesced; the metadata layout is
exactly tbz's.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _cuda
from .. import constants as C
from .. import errors as E
from ..tape import STORED_FLAG, FrontendResult, TokenTape
from .tokenize_device import (TBITS, _e_extra, _e_nbits, _e_op, _e_val,
                              build_flat_table)

# Lanes decode EXT_BITS past their nominal end so consecutive lanes
# OVERLAP: lane l+1 starts mid-symbol and self-synchronizes onto the
# true symbol chain within a few symbols; the merge point is the first
# symbol-start position both lanes visited. The stitch finds it with a
# dense (HEAD x TAIL) equality test between lane l's last TAIL starts
# and lane l+1's first HEAD starts. No intersection (slow convergence,
# degenerate codes, errors) falls back to host sequential decode, so
# exactness never depends on synchronization.
EXT_BITS = 384
HEAD = 96   # merge candidates tested in the joining lane
TAIL = 144  # trailing starts carried from the previous lane

SYM_BITS_EXPECT = 7  # lane-tape sizing: expected bits/symbol (see
                     # _build_plan; overflow degrades to one host join)

# flag bits in the per-lane stitch metadata
F_MERGED = 1
F_SKIP = 2
F_DEAD = 4
F_EOB = 8

_BIG = 2 ** 31 - 1


def _lanes_multi_plain(data32, lit_flat, dist_flat, tbl_idx, lane_starts,
                       lane_ends, total_bits, S):
    """Plain PyTorch lockstep decode (the arithmetic of
    tbz/ops/batched.py:_lanes_multi, on int64 words)."""
    dev = data32.device
    words = data32.long() & 0xFFFFFFFF
    tbl_off = tbl_idx.long() << TBITS
    lit_flat = lit_flat.reshape(-1).long()
    dist_flat = dist_flat.reshape(-1).long()
    lane_ends = lane_ends.long()

    def peek(p, n):
        wi = p >> 5
        w = words[wi] | (words[wi + 1] << 32)
        return (w >> (p & 31)) & ((1 << n) - 1)

    L = lane_starts.shape[0]
    bit = lane_starts.long().clone()
    active = torch.ones(L, dtype=torch.bool, device=dev)
    bad = torch.zeros(L, dtype=torch.bool, device=dev)
    starts, packed, dist = [], [], []
    for _ in range(S):
        e = lit_flat[tbl_off + peek(bit, 15)]
        nb, op, ex = _e_nbits(e), _e_op(e), _e_extra(e)
        is_match = op == C.OP_MATCH
        p1 = bit + nb
        length = _e_val(e) + (peek(p1, 13) & ((1 << ex.clamp(0, 13)) - 1))
        p2 = p1 + torch.where(is_match, ex, 0)
        de = dist_flat[tbl_off + peek(p2, 15)]
        p3 = p2 + torch.where(is_match, _e_nbits(de), 0)
        dex = _e_extra(de)
        d = _e_val(de) + (peek(p3, 13) & ((1 << dex.clamp(0, 13)) - 1))
        p4 = p3 + torch.where(is_match, dex, 0)

        is_lit = op == C.OP_LITERAL
        is_end = op == C.OP_END
        invalid = (op == C.OP_INVALID) | (is_match
                                          & (_e_op(de) != C.OP_MATCH))
        next_bit = torch.where(is_match, p4, bit + nb)
        underrun = next_bit > total_bits
        emit = active & ~invalid & ~underrun
        packed.append(torch.where(emit & ~is_end,
                                  torch.where(is_lit, 1, length), 0)
                      | (torch.where(emit & is_lit, _e_val(e), 0) << 9)
                      | (torch.where(emit & is_end, 1, 0) << 17))
        starts.append(torch.where(emit, bit, -1))
        dist.append(torch.where(emit & is_match, d, 0))
        bad = bad | (active & (invalid | underrun))
        active = emit & ~is_end & ~(next_bit >= lane_ends)
        bit = torch.where(emit, next_bit, bit)
    i32 = torch.int32
    return (torch.stack(starts).to(i32), torch.stack(packed).to(i32),
            torch.stack(dist).to(i32), bit.to(i32), (~bad).to(i32))


def _lanes_multi(data32, lit_flat, dist_flat, tbl_idx, lane_starts,
                 lane_ends, total_bits: int, S: int, exits=None):
    """Lockstep decode of L lanes x S steps; lane l reads the tables of
    block tbl_idx[l] and runs from lane_starts[l] until it emits an EOB,
    crosses lane_ends[l] or fails.

    Returns (starts, packed, dist) int32[S, L] — start bit or -1 /
    len 9b | literal 8b << 9 | EOB << 17 / match distance — and exits
    int32[L] (the bit where each lane stopped; may be given, a view into
    the metadata buffer) and ok int32[L].

    Kernel (CUDA tensors): csrc/lanes.cu, one thread per lane, one-warp
    blocks that stage 2^11-entry litlen and 2^9-entry distance roots of
    up to 3 tables in shared memory (a step that meets a longer code or
    an unstaged table is redone from the full tables), and a register
    bit window. It takes tables from build_flat_table (any tbl_idx),
    whose short entries repeat at all their aliases. Replaces
    tbz/ops/batched.py:_lanes_multi. Bound: bytes, the 3 x L x S int32
    lane tape written; at small L the step's latency sets the time (see
    the source note)."""
    L = lane_starts.shape[0]
    dev = lane_starts.device
    if exits is None:
        exits = torch.empty(L, dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        starts, packed, dist, ex, ok = _lanes_multi_plain(
            data32, lit_flat, dist_flat, tbl_idx, lane_starts, lane_ends,
            total_bits, S)
        exits.copy_(ex)
        return starts, packed, dist, exits, ok
    i32 = torch.int32
    starts = torch.empty(S, L, dtype=i32, device=dev)
    packed = torch.empty(S, L, dtype=i32, device=dev)
    dist = torch.empty(S, L, dtype=i32, device=dev)
    ok = torch.empty(L, dtype=i32, device=dev)
    _cuda.require_cuda(data32, lit_flat, dist_flat, tbl_idx, lane_starts,
                       lane_ends, starts, packed, dist, exits, ok)
    for t in (data32, lit_flat, dist_flat, tbl_idx, lane_starts, lane_ends):
        if t.dtype != i32:
            raise ValueError("_lanes_multi takes int32 tensors")
    if lit_flat.data_ptr() % 16 or dist_flat.data_ptr() % 16:
        raise ValueError("_lanes_multi takes 16-byte aligned tables")
    lib = _cuda.lib()
    _cuda.count("lanes_multi")
    _cuda.check(lib.tbz_lanes(
        data32.data_ptr(), lit_flat.data_ptr(), dist_flat.data_ptr(),
        tbl_idx.data_ptr(), lane_starts.data_ptr(), lane_ends.data_ptr(),
        int(total_bits), L, S, starts.data_ptr(), packed.data_ptr(),
        dist.data_ptr(), exits.data_ptr(), ok.data_ptr(),
        _cuda.stream(data32)), "lanes_multi")
    return starts, packed, dist, exits, ok


def _stitch_compact_plain(starts, packed, dist, ok, tbl_idx, seg_id,
                          seg_sym, L, S, B, flat):
    """Plain PyTorch stitch + compaction (the arithmetic of
    tbz/ops/batched.py:191-297), writing `flat` in place."""
    dev = starts.device
    lit_errs = flat[7 * L:7 * L + B]
    dist_errs = flat[7 * L + B:7 * L + 2 * B]
    st = starts.t().long()                       # [L, S]
    pk = packed.t().long()
    ds = dist.t().long()
    n_syms = (st >= 0).sum(1)
    last = (n_syms - 1).clamp(0, S - 1)
    last_packed = pk.gather(1, last[:, None])[:, 0]
    has_eob = (n_syms > 0) & (((last_packed >> 17) & 1) == 1)
    tb = tbl_idx.long()
    usable = (ok != 0) & (lit_errs[tb] == 0) & (dist_errs[tb] == 0)
    starts_s = torch.where(st < 0, _BIG, st)

    # the stitch carries state lane to lane: a host loop over lanes
    n_h, use_h, eob_h = n_syms.tolist(), usable.tolist(), has_eob.tolist()
    seg_h, ssym_h = seg_id.tolist(), seg_sym.tolist()
    head_all = starts_s[:, :HEAD]
    tail = torch.full((TAIL,), _BIG, dtype=torch.long, device=dev)
    tail_idx = torch.zeros(TAIL, dtype=torch.long, device=dev)
    cur_seg, state = -1, 0
    mpos, cut_prev, flags, handoff = [], [], [], []
    for l in range(L):
        new_seg = seg_h[l] != cur_seg
        cur_seg = seg_h[l]
        if new_seg:
            state = 0
            tail = torch.full((TAIL,), _BIG, dtype=torch.long, device=dev)
            tail[0] = ssym_h[l]
            tail_idx = torch.zeros(TAIL, dtype=torch.long, device=dev)
        skip = state != 0
        head = head_all[l]
        eq = ((head[:, None] == tail[None, :]) & (tail[None, :] < _BIG))
        hits = torch.nonzero(eq)
        any_hit = hits.shape[0] > 0
        m0, k0 = (int(hits[0, 0]), int(hits[0, 1])) if any_hit else (0, 0)
        n = n_h[l]
        merged = use_h[l] and not skip and any_hit and m0 < n
        if not merged:
            m0 = 0
        cut_prev.append(int(tail_idx[k0]) if merged and not new_seg
                        else _BIG)
        handoff.append(int(head[m0]) if merged else -1)
        eob = eob_h[l]
        if merged and eob:
            state = 2
        flags.append((F_MERGED if merged else 0) | (F_SKIP if skip else 0)
                     | (F_DEAD if not skip and not merged else 0)
                     | (F_EOB if merged and eob else 0))
        mpos.append(m0)
        if not skip:
            base = min(max(n - TAIL, 0), S - TAIL)
            ti = torch.arange(base, base + TAIL, device=dev)
            tail = torch.where((ti >= m0) & (ti < n), starts_s[l, base:base
                                                                + TAIL],
                               _BIG)
            tail_idx = ti

    def t(v):
        return torch.tensor(v, dtype=torch.long, device=dev)

    mpos, cut_prev, flags, handoff = t(mpos), t(cut_prev), t(flags), \
        t(handoff)
    cut_next = torch.cat([cut_prev[1:], t([_BIG])])
    end_idx = torch.minimum(cut_next, n_syms - has_eob.long())
    nv = torch.where((flags & F_MERGED) != 0,
                     (end_idx - mpos).clamp(0, S), 0)
    off = torch.cumsum(nv, 0) - nv
    total = nv.sum()
    ln = pk & 0x1FF
    field = torch.where(ln == 1, (pk >> 9) & 0xFF, ds - 1)
    tok = ln | (field << 9)
    col = torch.arange(S, device=dev)[None, :]
    sel = (col >= mpos[:, None]) & (col < (mpos + nv)[:, None])
    nbytes = torch.where(sel, ln, 0).sum(1)
    compact = flat[7 * L + 2 * B + 1:]
    compact.zero_()
    tgt = off[:, None] + (col - mpos[:, None])
    compact[tgt[sel]] = tok[sel].to(torch.int32)
    for i, v in enumerate((mpos, nv, flags, handoff)):
        flat[i * L:(i + 1) * L] = v.to(torch.int32)
    flat[5 * L:6 * L] = off.to(torch.int32)
    flat[6 * L:7 * L] = nbytes.to(torch.int32)
    flat[7 * L + 2 * B] = total.to(torch.int32)
    return flat


def _stitch_compact(starts, packed, dist, ok, tbl_idx, seg_id, seg_sym,
                    L: int, S: int, B: int, flat):
    """Lane stitch + token compaction into the flat result buffer
    int32[7L + 2B + 1 + n_out + 1], whose exits and err words kernels 1
    and 2 have already written. Fills merge_pos | n_valid | flags |
    handoff | out_off | nbytes | total and the compact tokens
    (len 9b | field 16b, field = literal byte or dist - 1) in chain
    order; only compact[:total] is defined.

    Kernel (CUDA tensors): csrc/stitch.cu: a warp a lane finds each
    lane's first merge hit by a sorted intersection, a thread a lane
    repairs the few hits the merge-point mask removes and settles skip
    per segment, then counts, scan.cu for out_off and a warp a lane for
    the compaction. Replaces tbz/ops/batched.py:191-297. Bound: bytes
    (the lane tape read, the compact tape written)."""
    if starts.device.type == "cpu":
        return _stitch_compact_plain(starts, packed, dist, ok, tbl_idx,
                                     seg_id, seg_sym, L, S, B, flat)
    _launch_stitch(starts, packed, dist, ok, tbl_idx, seg_id, seg_sym, L,
                   S, B, flat, None)
    return flat


def _launch_stitch(starts, packed, dist, ok, tbl_idx, seg_id, seg_sym, L,
                   S, B, flat, pass_ms):
    _cuda.require_cuda(starts, packed, dist, ok, tbl_idx, seg_id, seg_sym,
                       flat)
    if flat.numel() != 7 * L + 2 * B + 1 + L * S + 1:
        raise ValueError("flat buffer size does not match (L, S, B)")
    lib = _cuda.lib()
    scratch = torch.empty(int(lib.tbz_stitch_scratch_ints(L)),
                          dtype=torch.int32, device=starts.device)
    ms = (ctypes.c_float * len(STITCH_PASSES))() if pass_ms else None
    _cuda.count("stitch_compact")
    _cuda.check(lib.tbz_stitch_compact(
        starts.data_ptr(), packed.data_ptr(), dist.data_ptr(),
        ok.data_ptr(), tbl_idx.data_ptr(), seg_id.data_ptr(),
        seg_sym.data_ptr(), L, S, B, flat.data_ptr(), scratch.data_ptr(),
        ms, _cuda.stream(starts)), "stitch_compact")
    return list(ms) if ms is not None else None


#: the passes of csrc/stitch.cu that stitch_pass_ms times, in order
STITCH_PASSES = ("lane_summary", "match", "carry", "counts_scan",
                 "compaction")


def stitch_pass_ms(starts, packed, dist, ok, tbl_idx, seg_id, seg_sym,
                   L: int, S: int, B: int, flat) -> dict:
    """One kernel-3 launch on CUDA tensors with CUDA events between its
    passes (it synchronizes): {pass: ms} over STITCH_PASSES."""
    ms = _launch_stitch(starts, packed, dist, ok, tbl_idx, seg_id, seg_sym,
                        L, S, B, flat, True)
    return dict(zip(STITCH_PASSES, ms))


def _batched_kernel(data32, lit_lens, dist_lens, tbl_idx, lane_starts,
                    lane_ends_ext, seg_id, seg_sym, total_bits: int,
                    L: int, S: int, B: int, n_out: int):
    """Table build + lane decode + stitch + compaction (kernels 1-3).

    Returns one flat int32 tensor: a [7L + 2B + 1] metadata header
    [merge_pos | n_valid | flags | handoff | exits | out_off | nbytes |
     lit_errs | dist_errs | total] followed by the [n_out + 1] compacted
    tokens in chain order (layout of tbz/ops/batched.py:_batched_kernel;
    only compact[:total] is defined)."""
    dev = data32.device
    flat = torch.empty(7 * L + 2 * B + 1 + n_out + 1, dtype=torch.int32,
                       device=dev)
    lit_tabs, dist_tabs, _, _ = build_flat_table(
        lit_lens, dist_lens, flat[7 * L:7 * L + B],
        flat[7 * L + B:7 * L + 2 * B])
    starts, packed, dist, _, ok = _lanes_multi(
        data32, lit_tabs, dist_tabs, tbl_idx, lane_starts, lane_ends_ext,
        total_bits, S, exits=flat[4 * L:5 * L])
    return _stitch_compact(starts, packed, dist, ok, tbl_idx, seg_id,
                           seg_sym, L, S, B, flat)


class Plan(NamedTuple):
    """Kernel launch plan (host numpy arrays; plan_from_numpy uploads
    it)."""
    L: int                  # padded lane count (pow2)
    S: int                  # max symbols per lane
    B: int                  # padded segment/table count (pow2)
    n_out: int              # compact token capacity (L*S)
    hdr_len: int            # metadata ints preceding the tokens
    Ln: int                 # real lane count
    Bn: int                 # real candidate count
    lane_starts: np.ndarray
    lane_ends: np.ndarray   # EXT_BITS-extended
    seg_id: np.ndarray
    tbl_idx: np.ndarray
    seg_sym: np.ndarray
    lit_pad: np.ndarray     # (B, 288) code lengths
    dist_pad: np.ndarray    # (B, 32)


def _plan_lanes(sym_bits, seg_ends, chunk_bits):
    """Lane layout over candidate segments: segment i's lanes tile
    [sym_bits[i], seg_ends[i]). Returns int32 arrays (starts, ends,
    seg_id) in global chain order."""
    starts, ends, seg = [], [], []
    for i, (s0, s1) in enumerate(zip(sym_bits, seg_ends)):
        n = max(1, -(-(s1 - s0) // chunk_bits))
        ls = s0 + np.arange(n, dtype=np.int64) * chunk_bits
        le = np.minimum(ls + chunk_bits, s1)
        starts.append(ls)
        ends.append(le)
        seg.append(np.full(n, i, np.int32))
    return (np.concatenate(starts).astype(np.int32),
            np.concatenate(ends).astype(np.int32),
            np.concatenate(seg))


def _build_plan(nbits: int, scan, chunk_bits: int) -> Plan:
    """Lane/table plan for one stream from the scanner's candidates.
    `scan` is the scan_headers tuple (hdr, symb, bfin, hlit, hdist,
    lens)."""
    hdr, symb, _bfin, hlit, hdist, lens = scan
    Bn = len(hdr)
    seg_ends = np.append(hdr[1:], nbits)
    lane_starts, lane_ends, seg_id = _plan_lanes(symb, seg_ends,
                                                 chunk_bits)
    Ln = len(lane_starts)
    L = 1 << max(4, (Ln - 1).bit_length())
    B = 1 << max(1, (Bn - 1).bit_length())
    # Lane tape sized for realistic symbol density, not the 5.33
    # bits/sym worst case: a lane that fills its tape still splices its
    # prefix and costs one host gap join (see _stitch_compact), so S is
    # a perf knob, not a correctness bound.
    S = max(256, (chunk_bits + EXT_BITS) // SYM_BITS_EXPECT)
    # lanes decode EXT_BITS past their nominal end (overlap merge)
    lane_ends = lane_ends + EXT_BITS
    # pad: extra lanes point at segment 0's table, cover nothing
    pad = L - Ln
    lane_starts = np.concatenate([lane_starts, np.zeros(pad, np.int32)])
    lane_ends = np.concatenate([lane_ends, np.zeros(pad, np.int32)])
    seg_id = np.concatenate([seg_id, np.zeros(pad, np.int32)])
    tbl_idx = seg_id.copy()
    seg_sym = np.zeros(L, np.int32)
    seg_sym[:Ln] = symb[seg_id[:Ln]]
    lit_pad = np.zeros((B, 288), np.int32)
    dist_pad = np.zeros((B, 32), np.int32)
    for i in range(Bn):
        lit_pad[i, :hlit[i]] = lens[i, :hlit[i]]
        dist_pad[i, :hdist[i]] = lens[i, hlit[i]:hlit[i] + hdist[i]]
    n_out = L * S
    hdr_len = 7 * L + 2 * B + 1
    return Plan(L, S, B, n_out, hdr_len, Ln, Bn, lane_starts, lane_ends,
                seg_id, tbl_idx, seg_sym, lit_pad, dist_pad)


class Meta(NamedTuple):
    """Parsed kernel metadata header (host copies)."""
    nv: np.ndarray
    flags: np.ndarray
    handoff: np.ndarray
    exits: np.ndarray
    off: np.ndarray
    nbytes: np.ndarray
    lit_errs: np.ndarray
    dist_errs: np.ndarray
    total: int


def _parse_meta(raw: np.ndarray, plan: Plan) -> Meta:
    L, B = plan.L, plan.B
    return Meta(nv=raw[L:2 * L], flags=raw[2 * L:3 * L],
                handoff=raw[3 * L:4 * L], exits=raw[4 * L:5 * L],
                off=raw[5 * L:6 * L], nbytes=raw[6 * L:7 * L],
                lit_errs=raw[7 * L:7 * L + B],
                dist_errs=raw[7 * L + B:7 * L + 2 * B],
                total=int(raw[7 * L + 2 * B]))


_empty = np.empty(0, np.int32)


def _walk(data: bytes, scan, plan: Plan, meta: Meta, stats,
          emit_dev, emit_host, end_block=lambda: None) -> int:
    """The host chain walk, driven by metadata only (no token values):
    reads block headers from the bit stream, decides per lane whether
    its compacted token range splices or a gap must be host-decoded,
    and reports the stream as an ordered sequence of
      emit_dev(lane, a, b)        — compact-token range [a, b)
      emit_host(ol, di, rv)       — host-generated tokens (stored
                                    blocks, unscanned blocks, junction
                                    gap joins)
      end_block()                 — after each block completes (the
                                    host-splice consumer validates
                                    distances per block here, so a bad
                                    distance in block N raises before a
                                    structural error in block N+1 —
                                    zlib's sequential error order)
    Returns end_bit. Raises the canonical frontend errors for
    structural problems; DISTANCE validation is the emitter's job
    (host splice: emit_block; fused: the device check)."""
    from ..bitreader import BitReader
    from ..errors import DeflateError, ERR_BAD_BLOCK_TYPE, \
        ERR_STORED_LEN_MISMATCH
    from .. import reference as R
    from ..native import loader as NL

    hdr, symb, _bfin, hlit, hdist, lens = scan
    Bn, Ln = plan.Bn, plan.Ln
    seg_id = plan.seg_id
    # lanes of each segment (contiguous ranges in lane order)
    seg_first = np.searchsorted(seg_id[:Ln], np.arange(Bn))
    seg_last = np.searchsorted(seg_id[:Ln], np.arange(Bn), side="right")
    hdr_pos = {int(h): i for i, h in enumerate(hdr)}

    def gap_to_eob(bit, ll, dl):
        """Native sequential decode to end-of-block; returns end bit."""
        ol, di, rv, end_bit, _, eob = NL.gap_decode(
            data, bit, ll, dl, _empty, 1 << 62, cap=1 << 16)
        if not eob:
            raise E.TruncatedError(
                "block symbol stream ended before its end-of-block code")
        stats["gap_syms"] += len(ol)
        emit_host(np.asarray(ol, np.int32), np.asarray(di, np.int32),
                  np.asarray(rv, np.int32))
        return end_bit

    def gap_join(bit, stop_bit, ll, dl):
        """Native sequential decode of a dead junction: walk the true
        chain from `bit` up to `stop_bit` (the next lane's handoff).
        Returns (landed_exactly, hit_eob, end_bit)."""
        ol, di, rv, end_bit, _, eob = NL.gap_decode(
            data, bit, ll, dl, _empty, stop_bit, cap=1 << 16)
        stats["gap_syms"] += len(ol)
        if len(ol):
            emit_host(np.asarray(ol, np.int32), np.asarray(di, np.int32),
                      np.asarray(rv, np.int32))
        return end_bit == stop_bit, eob, end_bit

    br = BitReader(data, 0)
    while True:
        bfinal = bool(br.bits(1))
        btype = br.bits(2)
        if btype == C.BTYPE_RESERVED:
            raise DeflateError("invalid block type 3", ERR_BAD_BLOCK_TYPE)
        stats["blocks"] += 1
        if btype == C.BTYPE_STORED:
            br.align_to_byte()
            ln0 = br.bits(16)
            nlen = br.bits(16)
            if ln0 != (~nlen & 0xFFFF):
                raise DeflateError("stored LEN/NLEN mismatch",
                                   ERR_STORED_LEN_MISMATCH)
            if ln0:
                o = br.bit_position() >> 3
                br.read_bytes_aligned(ln0)
                emit_host(np.array([ln0], np.int32),
                          np.array([0], np.int32),
                          np.array([STORED_FLAG | o], np.int32))
        else:
            hb = br.bit_position() - 3
            si = hdr_pos.get(hb) if btype == C.BTYPE_DYNAMIC else None
            if si is None or meta.lit_errs[si] or meta.dist_errs[si]:
                # static block, scanner miss, or device table failure:
                # host header parse (authoritative error classes) +
                # native sequential decode of this block
                if btype == C.BTYPE_STATIC:
                    ll = C.FIXED_LITLEN_LENGTHS
                    dl = C.FIXED_DIST_LENGTHS
                else:
                    lns, hl, hd = R._read_dynamic_lens(br)
                    ll, dl = lns[:hl], lns[hl:]
                stats["gap_blocks"] += 1
                end_bit = gap_to_eob(br.bit_position(), ll, dl)
                br = BitReader(data, end_bit)
            else:
                ll = lens[si, :hlit[si]]
                dl = lens[si, hlit[si]:hlit[si] + hdist[si]]
                done = False
                end_bit = None
                # last verified true-chain position (start of block)
                true_pos = int(symb[si])
                gapping = False  # a dead junction awaits a host join
                for l in range(int(seg_first[si]), int(seg_last[si])):
                    f = int(meta.flags[l])
                    if f & F_SKIP:
                        continue
                    if f & F_MERGED:
                        if gapping:
                            # host-join the junction: walk the true
                            # chain to this lane's handoff and verify
                            # the landing is exact
                            stats["joins"] += 1
                            landed, eob, eb = gap_join(
                                true_pos, int(meta.handoff[l]), ll, dl)
                            if eob:
                                done = True
                                end_bit = eb
                                break
                            if not landed:
                                # speculative chain was wrong past the
                                # junction: rest of block sequential
                                done = True
                                end_bit = gap_to_eob(eb, ll, dl)
                                break
                            gapping = False
                        stats["spliced"] += 1
                        a, b = int(meta.off[l]), \
                            int(meta.off[l]) + int(meta.nv[l])
                        if b > a:
                            emit_dev(l, a, b)
                        true_pos = int(meta.exits[l])
                        if f & F_EOB:
                            done = True
                            end_bit = true_pos
                            break
                    else:  # dead junction: join at the next merge
                        gapping = True
                if not done:
                    # block continues past the segment (false candidate
                    # ahead, capped coverage, or trailing dead lanes):
                    # finish it sequentially from the last true position
                    end_bit = gap_to_eob(true_pos, ll, dl)
                br = BitReader(data, end_bit)
        end_block()
        if bfinal:
            break
    return br.bit_position()


def _unpack_tokens(toks: np.ndarray):
    """compact int32 tokens -> (out_len, dist, root_val) int32."""
    ln = toks & 0x1FF
    field = toks >> 9
    is_lit = ln == 1
    di = np.where(is_lit, 0, field + 1).astype(np.int32)
    rv = np.where(is_lit, field, 0).astype(np.int32)
    return ln.astype(np.int32), di, rv


def _new_stats():
    """Stage times (ms, each after a device synchronize) and counts of
    one fused decode. D2H bytes are counted once each: the metadata
    header and the fetched output."""
    return {"scan_ms": 0.0, "kernel_ms": 0.0, "fetch_ms": 0.0,
            "walk_ms": 0.0, "resolve_ms": 0.0, "out_fetch_ms": 0.0,
            "fetches": 0, "candidates": 0, "blocks": 0, "spliced": 0,
            "gap_blocks": 0, "gap_syms": 0, "joins": 0,
            "meta_d2h_bytes": 0, "out_d2h_bytes": 0, "passes": 0}


class DevicePlan(NamedTuple):
    """A Plan's arrays as int32 tensors on the decode device."""
    lit_pad: torch.Tensor
    dist_pad: torch.Tensor
    tbl_idx: torch.Tensor
    lane_starts: torch.Tensor
    lane_ends: torch.Tensor
    seg_id: torch.Tensor
    seg_sym: torch.Tensor


def plan_from_numpy(plan, device) -> DevicePlan:
    """Upload a launch plan: `plan` is any object with the Plan's numpy
    fields (this module's Plan, or tbz.ops.batched.Plan as the parity
    tests pass it)."""
    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
    return DevicePlan(*(up(getattr(plan, f)) for f in DevicePlan._fields))


def stage_stream(data: bytes, device):
    """Upload a payload as little-endian int32 words, with 16 zero bytes
    of slack so every peek of the lane kernel (at most bit + 48, read as
    two words) stays in bounds."""
    pad = -(-len(data) // 4) * 4 + 16
    buf = np.zeros(pad, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    return torch.from_numpy(buf.view("<i4")).to(device)


def sync(device) -> None:
    """Wait for the device (stage timers read the clock after it)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _scan_and_launch(data: bytes, chunk_bits: int, stats, device):
    """Shared front half: stage the payload, scan headers, plan, launch
    kernels 1-3. Returns (scan, plan, flat, data32); scan is None when
    the scanner found no dynamic-block candidates (caller falls back)."""
    from ..native import loader as NL

    nbits = len(data) * 8
    t0 = time.perf_counter()
    data32 = stage_stream(data, device)
    scan = NL.scan_headers(data)
    stats["scan_ms"] = (time.perf_counter() - t0) * 1e3
    stats["candidates"] = len(scan[0])
    if len(scan[0]) == 0:
        return None, None, None, data32
    plan = _build_plan(nbits, scan, chunk_bits)
    t0 = time.perf_counter()
    flat = _batched_kernel(data32, *plan_from_numpy(plan, device), nbits,
                           plan.L, plan.S, plan.B, plan.n_out)
    sync(device)
    stats["kernel_ms"] = (time.perf_counter() - t0) * 1e3
    return scan, plan, flat, data32


def tokenize_stream_batched(data: bytes, window_len: int = 0,
                            chunk_bits: int = 8192,
                            collect_stats: bool = False, device=None):
    """Whole-stream batched speculative tokenize on `device` (default
    cuda): kernels 1-3, then the metadata and the compacted tokens are
    fetched and the host chain walk splices a token tape, validating
    distances block by block. A stream whose scan finds no dynamic-block
    candidates (stored-only or static-only) goes to
    ops/speculative.tokenize_stream_speculative with the payload already
    staged, and so does every stream where the native header scanner did
    not build. Returns a FrontendResult bit-identical to the other
    frontends, or (result, stats) when collect_stats."""
    from . import speculative as SP

    from ..native import loader as NL

    device = torch.device(device or "cuda")
    data = bytes(data)
    if not NL.available() or len(data) * 8 >= (1 << 31):
        return SP.tokenize_stream_speculative(
            data, window_len, collect_stats=collect_stats, device=device)

    stats = _new_stats()
    scan, plan, flat, data32 = _scan_and_launch(data, chunk_bits, stats,
                                                device)
    if scan is None:
        # no dynamic headers: hand the staged payload to the fallback
        res = SP.tokenize_stream_speculative(data, window_len, data32=data32,
                                             device=device)
        return (res, stats) if collect_stats else res

    hdr_len = plan.hdr_len
    t0 = time.perf_counter()
    meta = _parse_meta(flat[:hdr_len].cpu().numpy(), plan)
    compact = flat[hdr_len:hdr_len + meta.total].cpu().numpy()
    stats["fetch_ms"] = (time.perf_counter() - t0) * 1e3
    stats["fetches"] = 2
    stats["meta_d2h_bytes"] = 4 * hdr_len
    stats["token_d2h_bytes"] = 4 * meta.total
    all_ol, all_di, all_rv = _unpack_tokens(compact)

    # host chain walk (meta only) + host splice emitters
    t0 = time.perf_counter()
    parts: list = []
    produced = 0
    pend: list = []  # buffered device ranges, flushed before host tokens

    def emit_block(ol, di, rv):
        """Per-block distance validation (zlib checks inline) + append."""
        nonlocal produced
        if len(ol) == 0:
            return
        pref = np.cumsum(ol.astype(np.int64)) - ol
        bad = (di > pref + produced + window_len) & (di > 0)
        if np.any(bad):
            E.raise_for_code(E.ERR_BAD_DISTANCE)
        parts.append((ol, di, rv))
        produced += int(ol.sum())

    def flush():
        if pend:
            a = pend[0][0]
            b = pend[-1][1]
            emit_block(all_ol[a:b], all_di[a:b], all_rv[a:b])
            pend.clear()

    def emit_dev(l, a, b):
        # coalesce contiguous compact ranges into one emit_block call
        if pend and pend[-1][1] != a:
            flush()
        pend.append((a, b))

    def emit_host(ol, di, rv):
        flush()
        emit_block(ol, di, rv)

    end_bit = _walk(data, scan, plan, meta, stats, emit_dev, emit_host,
                    end_block=flush)
    flush()

    if parts:
        ol = np.concatenate([p[0] for p in parts])
        di = np.concatenate([p[1] for p in parts])
        rv = np.concatenate([p[2] for p in parts])
    else:
        ol = di = rv = np.zeros(0, np.int32)
    stats["walk_ms"] = (time.perf_counter() - t0) * 1e3
    tape = TokenTape(out_len=ol, dist=di, root_val=rv,
                     total_out=int(ol.sum()))
    res = FrontendResult(tape=tape, blocks=[], end_bit=end_bit,
                         finished=True)
    return (res, stats) if collect_stats else res
