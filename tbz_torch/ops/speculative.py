"""Speculative multi-lane in-block decode, one block a device call: the
port of tbz/ops/speculative.py, the device frontend's tier for streams
whose header scan finds no dynamic block (stored-only or static-only
streams of 64 KB and more).

One Huffman block's symbol stream is sequential at bit level, but the
code is self-synchronizing: a decoder started at a wrong bit offset
almost always converges onto the true symbol boundaries within a few
symbols. So L lanes decode from evenly spaced bit offsets in lockstep on
the device, and the host stitches them: the true entry of chunk l + 1 is
the first visited position at or past its start in the true decode of
chunk l; if lane l + 1 visited it, its tokens from there on are exact.
Unsynced spans are decoded sequentially (the native gap decoder, or the
Python decoder of the port's reference where the native library did not
build), so exactness never depends on synchronization. Distances are
validated at stitch time (lanes cannot know the output before them).

The device call (`_lanes_fused`) is kernel 1 with B = 1 (the block's
litlen and distance tables) followed by kernel 2 (`_lanes_multi`, every
lane on table 0); tbz's `_lanes_fused` / `_lanes_decode` need no kernel
of their own.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from .. import errors as E
from ..tape import TokenTape
from .batched import _lanes_multi
from .batched import stage_stream as stage_stream_device
from .tokenize_device import build_flat_table

MAX_ENTRY_DRIFT = 48  # a symbol spans < 48 bits; true chunk entry is
                      # within this window past the chunk start


def _lanes_fused(data32, lit_pad, dist_pad, lane_starts, lane_ends,
                 total_bits: int, L: int, max_syms: int):
    """Table build + lane decode for one block, returned as ONE flat
    int32 tensor: starts | packed | dist (each [max_syms, L], the lane
    kernel's slot-major tape) | ok | exits (each [L]) | lit err | dist
    err. The caller fetches it with one D2H and unpacks it on the host
    (_lanes_decode_unpack). The kernels write the exits and err words in
    place; one concatenation copies the tape and ok behind them."""
    dev = data32.device
    q = L * max_syms
    flat = torch.empty(3 * q + 2 * L + 2, dtype=torch.int32, device=dev)
    lt, dt, _, _ = build_flat_table(lit_pad[None], dist_pad[None],
                                    flat[-2:-1], flat[-1:])
    tbl_idx = torch.zeros(L, dtype=torch.int32, device=dev)
    starts, packed, dist, _, ok = _lanes_multi(
        data32, lt, dt, tbl_idx, lane_starts, lane_ends, total_bits,
        max_syms, exits=flat[3 * q + L:3 * q + 2 * L])
    torch.cat([starts.reshape(-1), packed.reshape(-1), dist.reshape(-1), ok],
              out=flat[:3 * q + L])
    return flat


def _lanes_decode_unpack(flat: np.ndarray, L: int, max_syms: int):
    """_lanes_fused's flat result (its err words cut off) as lane-major
    host arrays (tbz's layout): starts, out_len, dist (-1 for EOB), rv,
    n, ok, exits."""
    q = L * max_syms
    starts = flat[:q].reshape(max_syms, L).T
    packed = flat[q:2 * q].reshape(max_syms, L).T
    dist = flat[2 * q:3 * q].reshape(max_syms, L).T
    out_len = packed & 0x1FF
    rv = (packed >> 9) & 0xFF
    dist = np.where((packed >> 17) & 1, -1, dist)  # -1 marks EOB tokens
    n = (starts >= 0).sum(1).astype(np.int32)
    ok = flat[3 * q:3 * q + L].astype(bool)
    exits = flat[3 * q + L:3 * q + 2 * L]
    return starts, out_len, dist, rv, n, ok, exits


def tokenize_block_speculative(data: bytes, start_bit: int,
                               lit_lens: np.ndarray,
                               dist_lens: np.ndarray,
                               chunk_bits: int = 2048,
                               produced_before: int = 0,
                               window_len: int = 0,
                               data32=None, span_hint: int = 0,
                               device=None):
    """Speculatively decode one block's symbol stream (tables known,
    from `start_bit` up to its end-of-block) on `device` (default cuda).

    Returns (TokenTape, end_bit, stats); stats reports lane
    synchronization. data32: the payload from stage_stream_device
    (uploaded here when absent)."""
    from .. import huffman
    device = torch.device(device or "cuda")
    lit_lens = np.asarray(lit_lens, np.int64)
    dist_lens = np.asarray(dist_lens, np.int64)
    # host validation first: raises the proper DeflateErrors on bad code
    # sets
    lit2 = huffman.build_decode_table_checked(lit_lens, huffman.KIND_LITLEN)
    dist2 = huffman.build_decode_table_checked(dist_lens, huffman.KIND_DIST)
    lit_pad = np.zeros(288, np.int32)
    lit_pad[:len(lit_lens)] = lit_lens
    dist_pad = np.zeros(32, np.int32)
    dist_pad[:len(dist_lens)] = dist_lens

    nbits = len(data) * 8
    if data32 is None:
        data32 = stage_stream_device(data, device)

    span = nbits - start_bit
    if span_hint:
        # lanes past the block's EOB decode other blocks' bits with the
        # wrong tables: cap coverage near the estimated block length (the
        # stitcher finishes a longer block sequentially)
        span = min(span, max(span_hint, 4 * chunk_bits))
    L = max(1, min(256, span // chunk_bits))
    L = 1 << (L - 1).bit_length()
    # symbols are >= ~3 bits in real codes; a lane that fills its tape
    # is merely unusable for merging (its chunk falls to the stitcher)
    max_syms = max(256, chunk_bits * 3 // 16)
    lane_starts = np.array(
        [min(start_bit + l * chunk_bits, nbits) for l in range(L)],
        np.int32)
    lane_ends = np.minimum(lane_starts + chunk_bits, nbits).astype(np.int32)

    def up(a):
        return torch.from_numpy(a).to(device)

    # ONE device call + ONE fetch per block: table build + lanes
    flat = _lanes_fused(data32, up(lit_pad), up(dist_pad), up(lane_starts),
                        up(lane_ends), nbits, L, max_syms).cpu().numpy()
    errs = flat[-2:]
    if int(errs[0]) != 0 or int(errs[1]) != 0:
        # the host validated the same code set above, so a device table
        # error is a disagreement between the two: raise it
        E.raise_for_code(int(errs[0]) or int(errs[1]))
    starts, out_len, dist, rv, n_syms, ok, exits = _lanes_decode_unpack(
        flat[:-2], L, max_syms)

    # the sequential decoder where the native library did not build
    # (fallback and EOB finisher), on the host tables validated above
    from ..bitreader import BitReader
    from .. import reference as R

    def decode_one(br):
        """(kind, out_len, dist, rv): kind 0 = literal/match, 1 = EOB."""
        op, extra, val = R._decode_symbol(br, lit2, huffman.KIND_LITLEN)
        if op == C.OP_END:
            return 1, 0, 0, 0
        if op == C.OP_LITERAL:
            return 0, 1, 0, val
        length = val + (br.bits(extra) if extra else 0)
        _, dex, dval = R._decode_symbol(br, dist2, huffman.KIND_DIST)
        d = dval + (br.bits(dex) if dex else 0)
        return 0, length, d, 0

    def seq_decode(bit):
        br = BitReader(data, bit)
        ol, di, rvv = [], [], []
        while True:
            kind, tl, td, tr = decode_one(br)
            if kind == 1:
                return (np.array(ol, np.int32), np.array(di, np.int32),
                        np.array(rvv, np.int32), br.bit_position())
            ol.append(tl)
            di.append(td)
            rvv.append(tr)

    from ..native import loader as NL
    use_native = NL.available()
    _empty = np.empty(0, np.int32)
    toks_ol: list = []
    toks_di: list = []
    toks_rv: list = []
    synced = 0
    fallbacks = 0
    gap_syms = 0
    entry = start_bit
    hit_eob = False
    eob_consumed = False  # the native gap decode consumes the EOB symbol
    for l in range(L):
        if entry >= int(lane_ends[l]) or hit_eob:
            continue  # a previous gap decode already covered this chunk
        row_n = int(n_syms[l])
        row_starts = starts[l, :row_n]
        # a lane that filled its tape may have stopped mid-chunk: its
        # visited set merges only if it ended cleanly AND reached its end
        usable = bool(ok[l]) and (row_n < max_syms
                                  or int(exits[l]) >= int(lane_ends[l]))
        # gap decode: walk the TRUE chain from `entry` until it lands on a
        # position this lane visited, or past the lane
        merge = None
        if usable:
            pos = int(np.searchsorted(row_starts, entry))
            if pos < row_n and row_starts[pos] == entry:
                merge = pos
        if merge is None and use_native:
            g_ol, g_di, g_rv, entry2, midx, g_eob = NL.gap_decode(
                data, entry, lit_lens, dist_lens,
                row_starts if usable else _empty, int(lane_ends[l]))
            gap_syms += len(g_ol)
            if len(g_ol):
                toks_ol.append(g_ol)
                toks_di.append(g_di)
                toks_rv.append(g_rv)
            if g_eob:
                hit_eob = True
                eob_consumed = True
                entry = entry2  # already past the EOB symbol
                continue
            if midx >= 0:
                merge = midx
            else:
                entry = entry2
                fallbacks += 1
                continue
        elif merge is None:
            br = BitReader(data, entry)
            g_ol, g_di, g_rv = [], [], []
            while True:
                p = br.bit_position()
                if usable:
                    pos = int(np.searchsorted(row_starts, p))
                    if pos < row_n and row_starts[pos] == p:
                        merge = pos
                        break
                if p >= int(lane_ends[l]):
                    entry = p
                    break
                kind, tl, td, tr = decode_one(br)
                gap_syms += 1
                if kind == 1:
                    hit_eob = True
                    entry = p  # EOB start; the sequential tail finishes
                    break
                g_ol.append(tl)
                g_di.append(td)
                g_rv.append(tr)
            if g_ol:
                toks_ol.append(np.array(g_ol, np.int32))
                toks_di.append(np.array(g_di, np.int32))
                toks_rv.append(np.array(g_rv, np.int32))
            if merge is None:
                fallbacks += 1
                continue  # the next lane stitches from the updated entry
        synced += 1
        seg_d = dist[l, merge:row_n]
        eob_rel = np.nonzero(seg_d == -1)[0]
        if eob_rel.size:
            j = merge + int(eob_rel[0])
            toks_ol.append(out_len[l, merge:j])
            toks_di.append(dist[l, merge:j])
            toks_rv.append(rv[l, merge:j])
            entry = int(starts[l, j])  # EOB symbol start; tail decodes it
            hit_eob = True
            continue
        toks_ol.append(out_len[l, merge:row_n])
        toks_di.append(dist[l, merge:row_n])
        toks_rv.append(rv[l, merge:row_n])
        entry = int(exits[l])

    if eob_consumed:
        ol2 = di2 = rv2 = _empty
        end_bit = entry
    elif use_native:
        ol2, di2, rv2, end_bit, _, tail_eob = NL.gap_decode(
            data, entry, lit_lens, dist_lens, _empty, 1 << 62)
        if not tail_eob:
            raise E.TruncatedError(
                "block symbol stream ended before its end-of-block code")
    else:
        ol2, di2, rv2, end_bit = seq_decode(entry)
    ol = np.concatenate(toks_ol + [ol2]) if toks_ol else ol2
    di = np.concatenate(toks_di + [di2]) if toks_di else di2
    rvv = np.concatenate(toks_rv + [rv2]) if toks_rv else rv2

    # deferred distance validation (lanes cannot know the produced prefix)
    produced = np.cumsum(ol.astype(np.int64)) - ol
    bad = di > (produced + produced_before + window_len)
    if np.any(bad & (di > 0)):
        E.raise_for_code(E.ERR_BAD_DISTANCE)

    tape = TokenTape(out_len=ol.astype(np.int32), dist=di.astype(np.int32),
                     root_val=rvv.astype(np.int32), total_out=int(ol.sum()))
    stats = {"lanes": L, "synced": synced, "fallbacks": fallbacks,
             "gap_syms": gap_syms,
             "sync_rate": synced / L if L else 1.0, "hit_eob": hit_eob}
    return tape, end_bit, stats


def tokenize_stream_speculative(data: bytes, window_len: int = 0,
                                chunk_bits: int = 2048,
                                collect_stats: bool = False,
                                data32=None, device=None):
    """Whole-stream speculative tokenize on `device` (default cuda).
    Block headers are parsed sequentially on the host; each static or
    dynamic block's symbol stream decodes with lockstep lanes on the
    device; stored blocks are emitted directly. data32: the payload
    already staged by a caller (the batched tier, after a scan with no
    candidates), else uploaded at the first compressed block.

    Returns a FrontendResult bit-identical to the other frontends, or
    (result, stats) when collect_stats."""
    from ..bitreader import BitReader
    from ..errors import DeflateError, ERR_BAD_BLOCK_TYPE, \
        ERR_STORED_LEN_MISMATCH
    from ..tape import STORED_FLAG, FrontendResult
    from .. import reference as R

    device = torch.device(device or "cuda")
    data = bytes(data)
    br = BitReader(data, 0)
    parts: list = []
    produced = 0
    all_stats: list = []
    block_bits_ewma = 0  # running block-length estimate (lane coverage)
    while True:
        bfinal = bool(br.bits(1))
        btype = br.bits(2)
        if btype == C.BTYPE_RESERVED:
            raise DeflateError("invalid block type 3", ERR_BAD_BLOCK_TYPE)
        if btype == C.BTYPE_STORED:
            br.align_to_byte()
            ln = br.bits(16)
            nlen = br.bits(16)
            if ln != (~nlen & 0xFFFF):
                raise DeflateError("stored LEN/NLEN mismatch",
                                   ERR_STORED_LEN_MISMATCH)
            if ln:
                off = br.bit_position() >> 3
                br.read_bytes_aligned(ln)
                parts.append((np.array([ln], np.int32),
                              np.array([0], np.int32),
                              np.array([STORED_FLAG | off], np.int32)))
                produced += ln
        else:
            if btype == C.BTYPE_STATIC:
                lit_lens = C.FIXED_LITLEN_LENGTHS
                dist_lens = C.FIXED_DIST_LENGTHS
            else:
                lens, hlit, hdist = R._read_dynamic_lens(br)
                lit_lens = lens[:hlit]
                dist_lens = lens[hlit:]
            if data32 is None:
                data32 = stage_stream_device(data, device)
            b0 = br.bit_position()
            tape, end_bit, stats = tokenize_block_speculative(
                data, b0, lit_lens, dist_lens,
                chunk_bits=chunk_bits, produced_before=0,
                window_len=produced + window_len, data32=data32,
                span_hint=int(block_bits_ewma * 3) // 2, device=device)
            block_bits_ewma = (end_bit - b0 if block_bits_ewma == 0 else
                               (block_bits_ewma + (end_bit - b0)) // 2)
            all_stats.append(stats)
            if len(tape):
                parts.append((tape.out_len, tape.dist, tape.root_val))
                produced += tape.total_out
            br = BitReader(data, end_bit)
        if bfinal:
            break
    if parts:
        ol = np.concatenate([p[0] for p in parts])
        di = np.concatenate([p[1] for p in parts])
        rv = np.concatenate([p[2] for p in parts])
    else:
        ol = di = rv = np.zeros(0, np.int32)
    tape = TokenTape(out_len=ol, dist=di, root_val=rv,
                     total_out=int(ol.sum()))
    res = FrontendResult(tape=tape, blocks=[],
                         end_bit=br.bit_position(), finished=True)
    if collect_stats:
        agg = {
            "blocks": len(all_stats),
            "lanes": sum(s["lanes"] for s in all_stats),
            "synced": sum(s["synced"] for s in all_stats),
            "gap_syms": sum(s["gap_syms"] for s in all_stats),
        }
        return res, agg
    return res
