"""The all-device tokenizer and its flat Huffman decode tables, the port
of tbz/ops/tokenize_device.py.

A flat table has 2^15 slots in bit-reversed order: the next 15 stream
bits (LSB-first) index the entry of the symbol whose code they start
with. Entries are packed as in constants.py (nbits 0:4 | op 4:7 |
extra 7:12 | val 16:32); every value fits in 31 bits, so tables are
held as int32. Uncovered slots hold C.INVALID_ENTRY.

`build_flat_table` builds the litlen and distance tables of B blocks in
one launch (csrc/tables.cu); `tokenize_device_impl` runs the sequential
inflate state machine (block headers, stored runs, dynamic code lengths,
one symbol a step) into a token tape (csrc/inflate.cu). Both launch their
kernel for CUDA tensors and run the plain versions below for CPU
tensors. `tokenize_device` and `tokenize_auto` are the host wrappers
with the frontend contract (frontend.tokenize(frontend="device")).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _cuda
from .. import constants as C
from .. import errors as E
from ..tape import STORED_FLAG, FrontendResult, TokenTape

TBITS = 15
TSIZE = 1 << TBITS

# Modes of the decode state machine (tbz/ops/tokenize_device.py:41-50).
M_BLOCK = 0      # read BFINAL/BTYPE
M_STORED = 1     # emit stored-run token
M_DATA = 2       # decode one litlen symbol (+match)
M_DHT_SIZES = 3  # read HLIT/HDIST/HCLEN
M_DHT_CLLEN = 4  # read one 3-bit code-length-code length
M_DHT_BUILD_CL = 5
M_DHT_LENS = 6   # decode one code-length symbol (with repeats)
M_DHT_BUILD = 7
M_DONE = 8
M_ERR = 9

_MAX_LENS = 320  # litlen + dist lengths; the CL lengths live at 300..318


@functools.lru_cache(maxsize=None)
def _rev15_np() -> np.ndarray:
    v = np.arange(1 << 15, dtype=np.int32)
    r = np.zeros(1 << 15, dtype=np.int32)
    for i in range(15):
        r |= ((v >> i) & 1) << (14 - i)
    return r


@functools.lru_cache(maxsize=None)
def _entry_consts() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-symbol packed entries sans nbits: (litlen[288], dist[32], cl[19])."""
    lit = np.zeros(288, np.uint32)
    for s in range(288):
        if s < 256:
            lit[s] = C.pack_entry(C.OP_LITERAL, 0, 0, s)
        elif s == 256:
            lit[s] = C.pack_entry(C.OP_END, 0, 0, 0)
        elif s <= 285:
            i = s - 257
            lit[s] = C.pack_entry(C.OP_MATCH, 0, int(C.LENGTH_EXTRA[i]),
                                  int(C.LENGTH_BASE[i]))
        else:
            lit[s] = C.pack_entry(C.OP_INVALID, 0, 0, 0)
    dist = np.zeros(32, np.uint32)
    for s in range(32):
        if s <= 29:
            dist[s] = C.pack_entry(C.OP_MATCH, 0, int(C.DIST_EXTRA[s]),
                                   int(C.DIST_BASE[s]))
        else:
            dist[s] = C.pack_entry(C.OP_INVALID, 0, 0, 0)
    cl = np.array([C.pack_entry(C.OP_LITERAL, 0, 0, s) for s in range(19)],
                  np.uint32)
    return lit, dist, cl


def _e_nbits(e): return e & 0xF
def _e_op(e): return (e >> C.ENTRY_OP_SHIFT) & 0x7
def _e_extra(e): return (e >> C.ENTRY_EXTRA_SHIFT) & 0x1F
def _e_val(e): return e >> C.ENTRY_VAL_SHIFT


def _build_flat_table_plain(lens: torch.Tensor, entry_const: torch.Tensor,
                            allow_single: bool):
    """Plain PyTorch flat tables for a batch of code-length rows.

    lens: int32[B, n_syms] (0 = unused); entry_const: int[n_syms].
    Returns (tables int32[B, 2^15], err int32[B]). err is
    ERR_BAD_HUFFMAN for an over-subscribed code, or an incomplete one
    unless allow_single and it is a single 1-bit code (zlib's exception,
    taken by litlen and distance codes but not by the code-length code);
    a table with err != 0 is never read."""
    dev = lens.device
    B, n = lens.shape
    ln = lens.long().clamp(0, 15)
    used = ln > 0
    lvl = torch.arange(16, device=dev)
    onehot = (ln[:, :, None] == lvl) & used[:, :, None]     # [B, n, 16]
    counts = onehot.sum(1)                                  # [B, 16]
    n_used = used.sum(1)
    max_len = ln.max(1).values
    kraft = (counts[:, 1:] << (15 - lvl[1:])).sum(1)
    single_ok = (max_len == 1) & (n_used == 1) & allow_single
    bad = (kraft > TSIZE) | ((kraft < TSIZE) & (n_used > 0) & ~single_ok)
    err = torch.where(bad, E.ERR_BAD_HUFFMAN, E.OK).to(torch.int32)

    next_code = torch.zeros(B, 16, dtype=torch.long, device=dev)
    code = torch.zeros(B, dtype=torch.long, device=dev)
    for k in range(1, 16):
        code = (code + counts[:, k - 1]) << 1
        next_code[:, k] = code
    # rank of each symbol among the used symbols of its length
    rank = onehot.long().cumsum(1).gather(2, ln[:, :, None])[:, :, 0] - 1
    codes = (next_code.gather(1, ln) + rank) & ((1 << ln) - 1)
    # an l-bit code reversed: rev15 of the code left-aligned in 15 bits
    rev15 = torch.from_numpy(_rev15_np()).to(dev).long()
    rev = rev15[codes << (15 - ln)]
    entry = (entry_const.long()[None, :] | ln).to(torch.int32)

    table = torch.full((B, TSIZE), C.INVALID_ENTRY, dtype=torch.int32,
                       device=dev)
    for length in range(1, 16):
        bs, syms = torch.nonzero(ln == length, as_tuple=True)
        if bs.numel() == 0:
            continue
        j = torch.arange(1 << (15 - length), device=dev)
        slots = rev[bs, syms][:, None] + (j[None, :] << length)
        table[bs[:, None], slots] = entry[bs, syms][:, None]
    return table, err


@functools.lru_cache(maxsize=8)
def _all_consts_on(device: torch.device) -> torch.Tensor:
    """litlen[288] | dist[32] | cl[19] packed entries, int32 on `device`
    (the inflate kernel's constant table)."""
    return torch.from_numpy(np.concatenate(_entry_consts()).view(np.int32)
                            ).to(device)


def _consts_on(device: torch.device):
    """The litlen and distance entry constants on `device`."""
    c = _all_consts_on(device)
    return c[:288], c[288:320]


def build_flat_table(lit_lens: torch.Tensor, dist_lens: torch.Tensor,
                     lit_errs: torch.Tensor | None = None,
                     dist_errs: torch.Tensor | None = None):
    """Litlen and distance flat tables of B blocks (zlib's single-1-bit
    exception allowed for both, as the batched decode uses them).

    lit_lens int32[B, 288], dist_lens int32[B, 32]. Returns
    (lit_tabs int32[B, 2^15], dist_tabs int32[B, 2^15], lit_errs
    int32[B], dist_errs int32[B]); the err outputs may be given (views
    into the batched kernel's metadata buffer).

    Kernel (CUDA tensors): csrc/tables.cu, eight 128-thread blocks a
    table, each thread the 32 aliases of one root slot, found by binary
    search over the canonical starts and stored straight to global
    memory. Equal to the plain version wherever the code is not
    over-subscribed; an over-subscribed table (err != 0) leaves out the
    codes past 2^15. Replaces tbz/ops/tokenize_device.py:build_flat_table
    (vmapped at tbz/ops/batched.py:179-182). Bound: bytes, 2 x B x 128 KB
    of table written; see the source note for the design."""
    B = lit_lens.shape[0]
    dev = lit_lens.device
    if lit_errs is None:
        lit_errs = torch.empty(B, dtype=torch.int32, device=dev)
    if dist_errs is None:
        dist_errs = torch.empty(B, dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        lit_c, dist_c = _consts_on(dev)
        lt, le = _build_flat_table_plain(lit_lens, lit_c, True)
        dt, de = _build_flat_table_plain(dist_lens, dist_c, True)
        lit_errs.copy_(le)
        dist_errs.copy_(de)
        return lt, dt, lit_errs, dist_errs
    if lit_lens.shape[1] != 288 or dist_lens.shape[1] != 32:
        raise ValueError("build_flat_table takes [B, 288] and [B, 32] lengths")
    lit_lens = lit_lens.to(torch.int32).contiguous()
    dist_lens = dist_lens.to(torch.int32).contiguous()
    lit_c, dist_c = _consts_on(dev)
    lit_tabs = torch.empty(B, TSIZE, dtype=torch.int32, device=dev)
    dist_tabs = torch.empty(B, TSIZE, dtype=torch.int32, device=dev)
    _cuda.require_cuda(lit_lens, dist_lens, lit_c, dist_c, lit_tabs,
                       dist_tabs, lit_errs, dist_errs)
    lib = _cuda.lib()
    _cuda.count("build_flat_table")
    _cuda.check(lib.tbz_build_tables(
        lit_lens.data_ptr(), dist_lens.data_ptr(), B, lit_c.data_ptr(),
        dist_c.data_ptr(), lit_tabs.data_ptr(), dist_tabs.data_ptr(),
        lit_errs.data_ptr(), dist_errs.data_ptr(),
        _cuda.stream(lit_lens)), "build_flat_table")
    return lit_tabs, dist_tabs, lit_errs, dist_errs


# --- the sequential device tokenizer ---------------------------------------

def _tokenize_device_plain(data32, total_bits: int, window_len: int,
                           T: int):
    """Plain version of the inflate state machine: the buffer is read once
    (.tolist()) and the machine runs in scalar Python, mode by mode and
    check by check in tbz's order (tbz/ops/tokenize_device.py:197-554);
    tables come from _build_flat_table_plain (the code-length table
    without zlib's single-1-bit exception). Returns (tape int32[3, T],
    res int32[5]) on data32's device, as tokenize_device_impl."""
    dev = data32.device
    words = [w & 0xFFFFFFFF for w in data32.tolist()]
    nw = len(words)
    consts = _all_consts_on(dev)
    lit_c, dist_c, cl_c = consts[:288], consts[288:320], consts[320:]

    def peek(p, n):
        wi = p >> 5
        w0 = words[wi] if wi < nw else 0
        w1 = words[wi + 1] if wi + 1 < nw else 0
        return ((w0 | (w1 << 32)) >> (p & 31)) & ((1 << n) - 1)

    def table(lens, consts, allow_single):
        t, e = _build_flat_table_plain(
            torch.tensor([lens], dtype=torch.int32, device=dev), consts,
            allow_single)
        return [v & 0xFFFFFFFF for v in t[0].tolist()], int(e[0])

    ol, di, rv = [], [], []
    bit_pos = bfinal = produced = finished = 0
    mode, err = M_BLOCK, E.OK
    lit_tab = dist_tab = cl_tab = None
    hlit = hdist = hclen = cl_i = lens_i = stored_len = 0
    lens = [0] * _MAX_LENS

    def emit(length, d, r):
        nonlocal produced, err
        if len(ol) >= T:
            err = E.ERR_TAPE_OVERFLOW
            return
        ol.append(length)
        di.append(d)
        rv.append(r)
        produced += length

    while mode not in (M_DONE, M_ERR) and err == E.OK:
        if mode == M_BLOCK:
            ok = bit_pos + 3 <= total_bits
            hdr = peek(bit_pos, 3)
            if not ok:
                mode, err = M_ERR, E.ERR_TRUNCATED
                continue
            bfinal, btype = hdr & 1, hdr >> 1
            if btype == 0:
                pos = (bit_pos + 3 + 7) & ~7
                ok2 = pos + 32 <= total_bits
                ln, nlen = peek(pos, 16), peek(pos + 16, 16)
                good = ln == (~nlen & 0xFFFF)
                have = pos + 32 + ln * 8 <= total_bits
                bit_pos, stored_len = pos + 32, ln
                # header truncation, then LEN/NLEN, then the payload
                if not ok2:
                    mode, err = M_ERR, E.ERR_TRUNCATED
                elif not good:
                    mode, err = M_ERR, E.ERR_STORED_LEN_MISMATCH
                elif not have:
                    mode, err = M_ERR, E.ERR_TRUNCATED
                else:
                    mode = M_STORED
            elif btype == 1:
                lit_tab, _ = table(C.FIXED_LITLEN_LENGTHS.tolist(), lit_c,
                                   True)
                dist_tab, _ = table(C.FIXED_DIST_LENGTHS.tolist(), dist_c,
                                    True)
                bit_pos, mode = bit_pos + 3, M_DATA
            elif btype == 2:
                bit_pos, mode = bit_pos + 3, M_DHT_SIZES
            else:
                mode, err = M_ERR, E.ERR_BAD_BLOCK_TYPE
        elif mode == M_STORED:
            if stored_len > 0:
                emit(stored_len, 0, STORED_FLAG | (bit_pos >> 3))
            bit_pos += stored_len * 8
            mode = M_DONE if bfinal else M_BLOCK
            finished = 1 if bfinal else finished
        elif mode == M_DATA:
            e = lit_tab[peek(bit_pos, 15)]
            nb = _e_nbits(e)
            ok = bit_pos + nb <= total_bits
            op = _e_op(e)
            if op == C.OP_INVALID:
                mode, err = M_ERR, E.ERR_INVALID_CODE
            elif op == C.OP_LITERAL:
                emit(1, 0, _e_val(e))
                bit_pos += nb
            elif op == C.OP_END:
                bit_pos += nb
                mode = M_DONE if bfinal else M_BLOCK
                finished = 1 if bfinal else finished
            else:
                p1 = bit_pos + nb
                ex = _e_extra(e)
                length = _e_val(e) + (peek(p1, 13) & ((1 << min(ex, 13)) - 1))
                p2 = p1 + ex
                de = dist_tab[peek(p2, 15)]
                p3 = p2 + _e_nbits(de)
                dex = _e_extra(de)
                d = _e_val(de) + (peek(p3, 13) & ((1 << min(dex, 13)) - 1))
                p4 = p3 + dex
                toofar = d > produced + window_len
                emit(length, d, 0)
                bit_pos = p4
                # the token is on the tape; then truncation, an invalid
                # distance code, a distance too far back
                if p4 > total_bits:
                    mode, err = M_ERR, E.ERR_TRUNCATED
                elif _e_op(de) != C.OP_MATCH:
                    mode, err = M_ERR, E.ERR_INVALID_CODE
                elif toofar:
                    mode, err = M_ERR, E.ERR_BAD_DISTANCE
            if not ok:  # truncation beats an invalid code
                mode, err = M_ERR, E.ERR_TRUNCATED
        elif mode == M_DHT_SIZES:
            ok = bit_pos + 14 <= total_bits
            v = peek(bit_pos, 14)
            hlit, hdist, hclen = (v & 31) + 257, ((v >> 5) & 31) + 1, \
                ((v >> 10) & 15) + 4
            bit_pos = bit_pos + 14 if ok else bit_pos
            cl_i, lens_i, lens = 0, 0, [0] * _MAX_LENS
            if not ok:
                mode, err = M_ERR, E.ERR_TRUNCATED
            elif hlit > 286 or hdist > 30:
                mode, err = M_ERR, E.ERR_TOO_MANY_SYMBOLS
            else:
                mode = M_DHT_CLLEN
        elif mode == M_DHT_CLLEN:
            ok = bit_pos + 3 <= total_bits
            lens[300 + int(C.CODE_LENGTH_ORDER[min(cl_i, 18)])] = \
                peek(bit_pos, 3) if ok else 0
            bit_pos = bit_pos + 3 if ok else bit_pos
            cl_i += 1
            if not ok:
                mode, err = M_ERR, E.ERR_TRUNCATED
            else:
                mode = M_DHT_BUILD_CL if cl_i >= hclen else M_DHT_CLLEN
        elif mode == M_DHT_BUILD_CL:
            cl_tab, e1 = table(lens[300:319], cl_c, False)
            if e1 != E.OK:
                mode, err = M_ERR, e1
            else:
                mode = M_DHT_LENS
            lens[300:] = [0] * (_MAX_LENS - 300)
        elif mode == M_DHT_LENS:
            e = cl_tab[peek(bit_pos, 15)]
            nb = _e_nbits(e)
            ok = bit_pos + nb <= total_bits
            sym = _e_val(e)
            invalid = _e_op(e) == C.OP_INVALID
            total = hlit + hdist
            i = lens_i
            rep_bits = 2 if sym == 16 else 3 if sym == 17 else 7
            rb = peek(bit_pos + nb, 7) & ((1 << rep_bits) - 1)
            rep = 3 + rb if sym in (16, 17) else 11 + rb
            rep_val = lens[max(i - 1, 0)] if sym == 16 else 0
            no_prev = sym == 16 and i == 0
            use_rep = sym >= 16
            overrun = use_rep and i + rep > total
            consumed = nb + (rep_bits if use_rep else 0)
            ok2 = bit_pos + consumed <= total_bits
            if ok and ok2 and not invalid and not no_prev and not overrun:
                if use_rep:
                    for k in range(i, min(i + rep, _MAX_LENS)):
                        lens[k] = rep_val
                else:
                    lens[min(i, _MAX_LENS - 1)] = sym
                lens_i = i + (rep if use_rep else 1)
                bit_pos += consumed
            bad_lit_overflow = sym < 16 and i >= total
            if not (ok and ok2):
                mode, err = M_ERR, E.ERR_TRUNCATED
            elif invalid:
                mode, err = M_ERR, E.ERR_INVALID_CODE
            elif no_prev or overrun or bad_lit_overflow:
                mode, err = M_ERR, E.ERR_BAD_CL_REPEAT
            elif lens_i >= total:
                mode = M_DHT_BUILD
        elif mode == M_DHT_BUILD:
            tl = [lens[k] if k < hlit else 0 for k in range(288)]
            td = [lens[min(k + hlit, _MAX_LENS - 1)] if k < hdist else 0
                  for k in range(32)]
            lit_tab, e1 = table(tl, lit_c, True)
            dist_tab, e2 = table(td, dist_c, True)
            # a missing end-of-block code first, then litlen, then dist
            e = E.ERR_BAD_HUFFMAN if lens[256] == 0 else (e1 or e2)
            if e != E.OK:
                mode, err = M_ERR, e
            else:
                mode = M_DATA

    n = len(ol)
    tape = torch.zeros(3, T, dtype=torch.int32, device=dev)
    if n:
        tape[:, :n] = torch.tensor([ol, di, rv], dtype=torch.int32,
                                   device=dev)
    res = torch.tensor([n, produced, bit_pos, err, finished],
                       dtype=torch.int32, device=dev)
    return tape, res


def stage_words(data: bytes, device) -> torch.Tensor:
    """A stream as little-endian int32 words with two zero words of slack
    (the machine's peek reads word wi + 1)."""
    buf = np.zeros(-(-len(data) // 4) * 4 + 8, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    return torch.from_numpy(buf.view("<i4")).to(device)


def tokenize_device_impl(data32, total_bits: int, window_len: int, T: int):
    """Sequential inflate of one stream into a token tape.

    data32: int32 little-endian words of the stream with at least 2 zero
    words of slack (stage_words). Returns (tape int32[3, T]
    = out_len | dist | root_val, zero past n_tok; res int32[5] = n_tok,
    produced, end_bit, err, finished), tbz's eight outputs.

    Kernel (CUDA tensors): csrc/inflate.cu, one block a call. Replaces
    tbz/ops/tokenize_device.py:191 tokenize_device_impl. Bound: latency;
    one thread walks the dependent bit-serial chain with its state and a
    bit buffer in registers, the stream staged through a shared-memory
    ring, and both tables in shared memory; the whole block builds each
    table (see the source note)."""
    if data32.device.type == "cpu":
        return _tokenize_device_plain(data32, total_bits, window_len, T)
    dev = data32.device
    if data32.dtype != torch.int32:
        raise ValueError("tokenize_device_impl takes int32 words")
    if not 0 <= total_bits < (1 << 31) or T < 1:
        raise ValueError("total_bits must fit int32 and T be positive")
    if data32.data_ptr() % 16:
        raise ValueError("tokenize_device_impl takes 16-byte aligned words")
    tape = torch.zeros(3, T, dtype=torch.int32, device=dev)
    res = torch.empty(5, dtype=torch.int32, device=dev)
    consts = _all_consts_on(dev)
    _cuda.require_cuda(data32, tape, res, consts)
    lib = _cuda.lib()
    _cuda.count("tokenize_device")
    _cuda.check(lib.tbz_inflate(
        data32.data_ptr(), data32.shape[0], int(total_bits), int(window_len),
        consts.data_ptr(), T, tape[0].data_ptr(), tape[1].data_ptr(),
        tape[2].data_ptr(), res.data_ptr(), _cuda.stream(data32)),
        "tokenize_device")
    return tape, res


#: streams at/above this size route through the speculative multi-lane
#: decoders (ops/batched, ops/speculative); below it the sequential
#: machine runs
SPECULATIVE_MIN_BYTES = 1 << 16


def tokenize_auto(data: bytes, window_len: int = 0,
                  device=None) -> FrontendResult:
    """Device-frontend dispatcher (the 'device' option of
    frontend.tokenize): large streams decode speculatively — batched
    (ops/batched, all blocks in one device pass) and per-block lockstep
    lanes (ops/speculative) when the header scan finds no dynamic block;
    small ones run the one-symbol-a-step sequential machine."""
    if len(data) >= SPECULATIVE_MIN_BYTES:
        from .batched import tokenize_stream_batched
        return tokenize_stream_batched(bytes(data), window_len,
                                       device=device)
    return tokenize_device(data, window_len, device=device)


def tokenize_device(data: bytes, window_len: int = 0, T: int | None = None,
                    device=None) -> FrontendResult:
    """Host wrapper with the frontend contract (raises on errors); runs
    on `device` (default cuda)."""
    device = torch.device(device or "cuda")
    data = bytes(data)
    if len(data) >= 1 << 28:
        raise ValueError("the sequential device tokenizer takes streams "
                         "below 256 MB (int32 bit positions)")
    nbits = len(data) * 8
    data32 = stage_words(data, device)
    # ~1 token a byte covers real streams; the RFC-hard bound is 8 tokens
    # a byte (a 1-bit literal code). On overflow jump straight to the
    # hard bound: exactly one retry.
    hard_T = 1 << max(10, (8 * len(data) + 16).bit_length())
    if T is None:
        T = 1 << max(10, len(data).bit_length())
    tape, res = tokenize_device_impl(data32, nbits, window_len, T)
    n_tok, produced, end_bit, err, finished = res.cpu().tolist()
    if err == E.ERR_TAPE_OVERFLOW:
        if T >= hard_T:
            raise RuntimeError("tape overflow at the RFC-hard token bound")
        return tokenize_device(data, window_len, hard_T, device)
    if err == E.ERR_TRUNCATED:
        raise E.TruncatedError("input underrun")
    E.raise_for_code(err)
    host = tape[:, :n_tok].cpu().numpy()
    tt = TokenTape(out_len=np.ascontiguousarray(host[0]),
                   dist=np.ascontiguousarray(host[1]),
                   root_val=np.ascontiguousarray(host[2]),
                   total_out=int(produced))
    return FrontendResult(tape=tt, blocks=[], end_bit=int(end_bit),
                          finished=bool(finished))
