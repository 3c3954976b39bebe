"""ctypes loader for the native host runtime (frontend.cc, a copy of
tbz's).

Compiled on demand with g++ into tbz_torch/native/build/ (cache keyed on
source mtime). Binds every entry of tbz's loader: the tokenizer, the
single-pass inflate (host backend, decompress_into, the paired inflate of
ZipReader.read_all), the speculative header scanner, the mid-block gap
decoder (the batched decode's chain walk), the flat span planner (the
declined-stream resolve, ops/resolve_spans), the resumable tokenizer and
host resolver (streaming), and the encoder's matchers, package-merge,
block planner and token packer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..errors import (TruncatedError, raise_for_code, ERR_TRUNCATED,
                      ERR_TAPE_OVERFLOW)
from ..tape import FrontendResult, TokenTape

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "frontend.cc")
_BUILD_DIR = os.path.join(_HERE, "build")
_SO = os.path.join(_BUILD_DIR, "libtbz.so")

_lib = None
_lock = threading.Lock()
_build_error: RuntimeError | None = None


class _FlatPlanC(ctypes.Structure):
    _fields_ = [
        ("n_batches", ctypes.c_int64),
        ("total_out", ctypes.c_int64),
        ("n_spans", ctypes.c_int64),
        ("err", ctypes.c_int32),
        ("pad_", ctypes.c_int32),
    ]


class FlatPlan:
    """Host-side FLAT-resolver plan (frontend.cc tbz_plan_spans_flat):
    literals pre-placed in out0 (uint8, row-padded), match spans packed
    as (G row-groups x K slots) batches. SOURCE addresses are global
    table coordinates (table = 256 window rows + output rows; srcaddr =
    src + 32768); SCATTER targets are segment-local (g_row in
    [0, seg_rows), b_segrow = the batch's segment base table row)."""

    def __init__(self, srcaddr, lenoff, g_row, b_segrow, out0, n_batches,
                 total_out, n_spans, G, K, seg_rows):
        self.srcaddr = srcaddr
        self.lenoff = lenoff
        self.g_row = g_row
        self.b_segrow = b_segrow
        self.out0 = out0
        self.n_batches = n_batches
        self.total_out = total_out
        self.n_spans = n_spans
        self.G = G
        self.K = K
        self.seg_rows = seg_rows


class _GapResult(ctypes.Structure):
    _fields_ = [
        ("n_tokens", ctypes.c_int64),
        ("end_bit", ctypes.c_int64),
        ("merge_idx", ctypes.c_int64),
        ("hit_eob", ctypes.c_int32),
        ("err", ctypes.c_int32),
    ]


class _TokResult(ctypes.Structure):
    _fields_ = [
        ("n_tokens", ctypes.c_int64),
        ("end_bit", ctypes.c_int64),
        ("total_out", ctypes.c_int64),
        ("finished", ctypes.c_int32),
        ("err", ctypes.c_int32),
        ("suspended", ctypes.c_int32),
        ("pad_", ctypes.c_int32),
    ]


def _build() -> str | None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    # Plain -O3: -march=native/-funroll-loops measured SLOWER on the
    # virtualized Xeon (worse branch behavior in the decode loop).
    cmd = ["g++", "-O3", "-shared", "-pthread",
           "-fPIC", "-std=c++17", "-o", _SO + ".tmp", _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(_SO + ".tmp", _SO)
        return _SO
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError) as e:
        err = getattr(e, "stderr", b"")
        raise RuntimeError(f"native build failed: {err!r}") from e


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            so = _build()
        except RuntimeError as e:
            _build_error = e
            return None
        lib = ctypes.CDLL(so)
        lib.tbz_tokenize.restype = ctypes.c_int32
        lib.tbz_tokenize.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(_TokResult)]
        lib.tbz_inflate_alloc.restype = ctypes.c_int32
        lib.tbz_inflate_alloc.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32)]
        lib.tbz_free.restype = None
        lib.tbz_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.tbz_gap_decode.restype = ctypes.c_int32
        lib.tbz_gap_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(_GapResult)]
        lib.tbz_scan_headers.restype = ctypes.c_int32
        lib.tbz_scan_headers.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
        lib.tbz_plan_spans_flat.restype = ctypes.c_int32
        lib.tbz_plan_spans_flat.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(_FlatPlanC)]
        lib.tbz_state_size.restype = ctypes.c_int64
        lib.tbz_state_size.argtypes = []
        lib.tbz_state_init.restype = None
        lib.tbz_state_init.argtypes = [ctypes.c_void_p]
        lib.tbz_tokenize_stream.restype = ctypes.c_int32
        lib.tbz_tokenize_stream.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(_TokResult)]
        lib.tbz_resolve.restype = ctypes.c_int32
        lib.tbz_resolve.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.tbz_inflate_into.restype = ctypes.c_int32
        lib.tbz_inflate_into.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32)]
        lib.tbz_pack.restype = ctypes.c_int64
        lib.tbz_pack.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_char_p,
            ctypes.c_int32, ctypes.c_uint64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int32)]
        lib.tbz_match.restype = ctypes.c_int64
        lib.tbz_match.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        lib.tbz_match_optimal.restype = ctypes.c_int64
        lib.tbz_match_optimal.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        lib.tbz_package_merge.restype = None
        lib.tbz_package_merge.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8)]
        lib.tbz_inflate_pair.restype = ctypes.c_int32
        lib.tbz_inflate_pair.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.tbz_plan_blocks.restype = ctypes.c_int64
        lib.tbz_plan_blocks.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def require():
    """The loaded library; raises the build error if it did not build
    (the device decode never trades its kernels for a host path)."""
    lib = _load()
    if lib is None:
        raise _build_error
    return lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _buf(data):
    """(pointer-compatible object, length, keepalive) without copying
    bytes-like/ndarray/memoryview input (zero-copy mmap path)."""
    if isinstance(data, bytes):
        return data, len(data), data
    arr = np.frombuffer(data, np.uint8)  # zero-copy view
    ptr = ctypes.cast(arr.ctypes.data, ctypes.c_char_p)
    return ptr, arr.size, arr


def tokenize(data, bit_pos: int = 0, window_len: int = 0,
             produced_init: int = 0) -> FrontendResult:
    """Native tokenizer; same contract as reference.tokenize_host
    (raises on malformed/truncated input)."""
    lib = require()
    dptr, dlen, _keep = _buf(data)
    # ~0.5 tokens per compressed byte is typical; x4 retry covers the rest.
    cap = max(1024, dlen)
    while True:
        out_len = np.empty(cap, np.int32)
        dist = np.empty(cap, np.int32)
        root_val = np.empty(cap, np.int32)
        res = _TokResult()
        lib.tbz_tokenize(dptr, dlen, bit_pos, window_len,
                         produced_init, _i32p(out_len), _i32p(dist),
                         _i32p(root_val), cap, ctypes.byref(res))
        if res.err == ERR_TAPE_OVERFLOW:
            cap *= 4
            continue
        if res.err == ERR_TRUNCATED:
            raise TruncatedError("input underrun")
        raise_for_code(res.err)
        n = res.n_tokens
        tape = TokenTape(out_len=out_len[:n], dist=dist[:n],
                         root_val=root_val[:n], total_out=int(res.total_out))
        return FrontendResult(tape=tape, blocks=[], end_bit=int(res.end_bit),
                              finished=bool(res.finished))


def gap_decode(data, start_bit: int, lit_lens, dist_lens,
               visited, lane_end_bit: int, cap: int = 4096):
    """Mid-block symbol decode with known code lengths, stopping at a
    visited-set merge / lane end / consumed EOB (the speculative
    stitcher's inner loop). Returns (out_len, dist, root_val, end_bit,
    merge_idx, hit_eob)."""
    lib = require()
    dptr, dlen, _keep = _buf(data)
    ll = np.ascontiguousarray(lit_lens, np.uint8).tobytes()
    dl = np.ascontiguousarray(dist_lens, np.uint8).tobytes()
    vis = np.ascontiguousarray(visited, np.int32)
    pieces = []
    merge_idx = -1
    hit_eob = False
    while True:
        out_len = np.empty(cap, np.int32)
        dist = np.empty(cap, np.int32)
        root_val = np.empty(cap, np.int32)
        res = _GapResult()
        err = lib.tbz_gap_decode(
            dptr, dlen, start_bit, ll, len(ll), dl, len(dl),
            _i32p(vis), len(vis), lane_end_bit,
            _i32p(out_len), _i32p(dist), _i32p(root_val), cap,
            ctypes.byref(res))
        n = int(res.n_tokens)
        if n:
            pieces.append((out_len[:n], dist[:n], root_val[:n]))
        start_bit = int(res.end_bit)
        if err == ERR_TAPE_OVERFLOW:
            continue
        if err == ERR_TRUNCATED:
            raise TruncatedError("input underrun")
        raise_for_code(err)
        merge_idx = int(res.merge_idx)
        hit_eob = bool(res.hit_eob)
        break
    if len(pieces) == 1:
        ol, di, rv = pieces[0]
    elif pieces:
        ol = np.concatenate([p[0] for p in pieces])
        di = np.concatenate([p[1] for p in pieces])
        rv = np.concatenate([p[2] for p in pieces])
    else:
        ol = di = rv = np.empty(0, np.int32)
    return ol, di, rv, start_bit, merge_idx, hit_eob


def scan_headers(data, from_bit: int = 0, to_bit: int = -1,
                 threads: int = 0, cap: int = 4096):
    """Speculatively scan the bit stream for plausible dynamic block
    headers (frontend.cc tbz_scan_headers). Acceptance is identical to
    the real header parse, so every true dynamic header is found; rare
    false positives are culled by the batched stitcher's chain walk.

    Returns (hdr_bits i64, sym_bits i64, bfinal i32, hlit i32, hdist i32,
    lens u8 (n, 320)), sorted by hdr_bit."""
    lib = require()
    dptr, dlen, _keep = _buf(data)
    if to_bit < 0:
        to_bit = dlen * 8
    while True:
        hdr = np.empty(cap, np.int64)
        sym = np.empty(cap, np.int64)
        bfinal = np.empty(cap, np.int32)
        hlit = np.empty(cap, np.int32)
        hdist = np.empty(cap, np.int32)
        lens = np.empty((cap, 320), np.uint8)
        n = ctypes.c_int64(0)
        overflow = lib.tbz_scan_headers(
            dptr, dlen, from_bit, to_bit, threads,
            hdr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            sym.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            _i32p(bfinal), _i32p(hlit), _i32p(hdist),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            cap, ctypes.byref(n))
        if overflow:
            cap *= 4
            continue
        k = int(n.value)
        return (hdr[:k], sym[:k], bfinal[:k], hlit[:k], hdist[:k],
                lens[:k])


def inflate(data, bit_pos: int = 0, window: bytes = b"",
            size_hint: int = 0) -> tuple[bytes, int, bool]:
    """Fused single-pass native inflate (the host fast path)."""
    lib = require()
    dptr, dlen, _keep = _buf(data)
    window = bytes(window)
    out_ptr = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_int64()
    end_bit = ctypes.c_int64()
    finished = ctypes.c_int32()
    err = lib.tbz_inflate_alloc(dptr, dlen, bit_pos, window,
                                len(window), size_hint,
                                ctypes.byref(out_ptr),
                                ctypes.byref(out_len),
                                ctypes.byref(end_bit),
                                ctypes.byref(finished))
    try:
        if err == ERR_TRUNCATED:
            raise TruncatedError("input underrun")
        raise_for_code(err)
        body = ctypes.string_at(out_ptr, out_len.value)
    finally:
        lib.tbz_free(out_ptr)
    return body, int(end_bit.value), bool(finished.value)


def plan_spans_flat(tape, input_bytes, window_len: int = 0,
                    G: int = 4096, K: int = 4,
                    seg_rows: int = 16384) -> FlatPlan:
    """Plan the FLAT device resolve (frontend.cc tbz_plan_spans_flat):
    literals host-prefilled into out0, match spans chopped to single
    src/dst 128B rows and list-scheduled into (G x K) batches that are
    segment-pure. seg_rows is clamped to the pow2 output row count.
    Streams are capped below 2 GB by int32 table addresses (ValueError;
    the caller resolves such a stream by pointer doubling)."""
    lib = require()
    dptr, dlen, _keep = _buf(input_bytes)
    n = len(tape)
    ol = np.ascontiguousarray(tape.out_len, np.int32)
    di = np.ascontiguousarray(tape.dist, np.int32)
    rv = np.ascontiguousarray(tape.root_val, np.int32)
    total = int(tape.total_out)
    if total > (1 << 31) - 65536:
        raise ValueError("flat resolver caps streams below 2GB "
                         "(int32 table addresses)")
    rows_out = max(1, -(-total // 128))
    if seg_rows & (seg_rows - 1):
        raise ValueError("seg_rows must be a power of two")
    seg_rows = min(seg_rows, 1 << (rows_out - 1).bit_length())
    out0 = np.zeros(rows_out * 128, np.uint8)
    batch_cap = (2 * n + total // 16) // G + 64
    while True:
        slot_cap = batch_cap * G * K
        srcaddr = np.empty(slot_cap, np.int32)
        lenoff = np.empty(slot_cap, np.int16)
        g_row = np.empty(batch_cap * G, np.int32)
        b_segrow = np.empty(batch_cap, np.int32)
        res = _FlatPlanC()
        err = lib.tbz_plan_spans_flat(
            _i32p(ol), _i32p(di), _i32p(rv), n, dptr, dlen,
            window_len, G, K, seg_rows,
            _i32p(srcaddr),
            lenoff.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), slot_cap,
            _i32p(g_row), _i32p(b_segrow), batch_cap * G, batch_cap,
            out0.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(out0), ctypes.byref(res))
        if err == ERR_TAPE_OVERFLOW:
            batch_cap *= 2
            continue
        raise_for_code(err)
        nb = int(res.n_batches)
        return FlatPlan(
            srcaddr=srcaddr[:nb * G * K], lenoff=lenoff[:nb * G * K],
            g_row=g_row[:nb * G], b_segrow=b_segrow[:nb], out0=out0,
            n_batches=nb, total_out=int(res.total_out),
            n_spans=int(res.n_spans), G=G, K=K, seg_rows=seg_rows)


def package_merge(freqs, limit: int) -> np.ndarray:
    """Optimal length-limited code lengths (C++ package-merge); same
    contract as huffman_encode.package_merge_lengths."""
    lib = require()
    f = np.ascontiguousarray(freqs, np.uint64)
    lens = np.zeros(len(f), np.uint8)
    lib.tbz_package_merge(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(f), limit,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return lens.astype(np.int32)


def plan_blocks(ol, di, li, unit: int):
    """Cost-aware block split (frontend.cc tbz_plan_blocks): same unit
    histogram + greedy pairwise entropy-merge fixpoint as
    deflate_encode._plan_blocks. Returns [(start, end)] token ranges,
    or None when the C++ planner declines (caller falls back to numpy)."""
    lib = require()
    n = len(ol)
    olc = np.ascontiguousarray(ol, np.int32)
    dic = np.ascontiguousarray(di, np.int32)
    lic = np.ascontiguousarray(li, np.int32)
    cap = max(1, -(-n // unit))
    ends = np.empty(cap, np.int64)
    nb = lib.tbz_plan_blocks(
        _i32p(olc), _i32p(dic), _i32p(lic), n, unit,
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
    if nb < 0:
        return None
    ends = ends[:nb]
    starts = np.concatenate(([0], ends[:-1]))
    return list(zip(starts.tolist(), ends.tolist()))


def new_stream_state():
    """Opaque resumable tokenizer state for tokenize_stream."""
    lib = require()
    buf = ctypes.create_string_buffer(int(lib.tbz_state_size()))
    lib.tbz_state_init(buf)
    return buf


def tokenize_stream(state, data, bit_pos: int, window_len: int,
                    produced_init: int, max_out: int = 0):
    """Resumable token-granular tokenizer. Consumes input up to the last
    complete token (never raises on underrun) and stops once max_out>0
    output bytes are tagged. The budget check precedes each token, so
    total_out <= max_out + 257 (the final token may be a full-length
    match; stored chunks split exactly at the budget).

    Returns (FrontendResult, suspended). `state` carries mid-block
    position + tables, so re-feeding never re-parses block data."""
    lib = require()
    dptr, dlen, _keep = _buf(data)
    bounded = max_out > 0
    in_bound = 8 * max(0, dlen - bit_pos // 8) + 64
    cap = min(max_out + 257, in_bound) if bounded else in_bound
    cap = max(cap, 1024)
    pieces = []
    total = 0
    finished = suspended = False
    while True:
        out_len = np.empty(cap, np.int32)
        dist = np.empty(cap, np.int32)
        root_val = np.empty(cap, np.int32)
        res = _TokResult()
        lib.tbz_tokenize_stream(dptr, dlen, bit_pos, window_len,
                                produced_init, max_out, state,
                                _i32p(out_len), _i32p(dist), _i32p(root_val),
                                cap, ctypes.byref(res))
        n = res.n_tokens
        if n:
            pieces.append((out_len[:n], dist[:n], root_val[:n]))
        total += int(res.total_out)
        bit_pos = int(res.end_bit)
        produced_init += int(res.total_out)
        if max_out > 0:
            max_out -= int(res.total_out)
        finished = bool(res.finished)
        suspended = bool(res.suspended)
        if res.err == ERR_TAPE_OVERFLOW:
            if bounded and max_out <= 0:
                # Budget exhausted exactly at the overflow: a retry with
                # max_out <= 0 would mean UNBOUNDED to the C side. The
                # state already holds a clean token-boundary suspend
                # point, so report suspension instead.
                suspended = True
                break
            continue  # state + end_bit resume cleanly with a fresh tape
        raise_for_code(res.err)
        break
    if len(pieces) == 1:
        ol, di, rv = pieces[0]
    elif pieces:
        ol = np.concatenate([p[0] for p in pieces])
        di = np.concatenate([p[1] for p in pieces])
        rv = np.concatenate([p[2] for p in pieces])
    else:
        ol = di = rv = np.empty(0, np.int32)
    tape = TokenTape(out_len=ol, dist=di, root_val=rv, total_out=total)
    return (FrontendResult(tape=tape, blocks=[], end_bit=bit_pos,
                           finished=finished), suspended)


def resolve(tape: TokenTape, data, window: bytes = b"") -> bytes:
    """Native host resolver (oracle/bench peer of ops/resolve.py)."""
    lib = require()
    dptr, dlen, _keep = _buf(data)
    window = bytes(window)
    out = np.empty(tape.total_out, np.uint8)
    ol = np.ascontiguousarray(tape.out_len, np.int32)
    di = np.ascontiguousarray(tape.dist, np.int32)
    rv = np.ascontiguousarray(tape.root_val, np.int32)
    err = lib.tbz_resolve(
        dptr, dlen, _i32p(ol), _i32p(di), _i32p(rv), len(ol),
        window, len(window),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(out))
    raise_for_code(err)
    return out.tobytes()


def inflate_pair(data0, data1, hint0: int, hint1: int):
    """Decode two independent raw-deflate streams in one interleaved
    native loop (frontend.cc tbz_inflate_pair): the single-stream
    literal decode is table-load-latency-bound, and a second
    independent chain hides most of it. Hints must be >= the true
    output sizes for the fast path to engage; anything irregular
    (bad stream, truncation, undersized hint) transparently re-decodes
    both streams through `inflate`, which owns exact error semantics.

    Returns (bytes0, bytes1)."""
    lib = require()
    d0, n0, _k0 = _buf(data0)
    d1, n1, _k1 = _buf(data1)
    out0 = np.empty(max(hint0, 1) + 32, np.uint8)
    out1 = np.empty(max(hint1, 1) + 32, np.uint8)
    w0 = ctypes.c_int64()
    w1 = ctypes.c_int64()
    e0 = ctypes.c_int64()
    e1 = ctypes.c_int64()
    rc = lib.tbz_inflate_pair(
        d0, n0, out0.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out0.size, ctypes.byref(w0), ctypes.byref(e0),
        d1, n1, out1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out1.size, ctypes.byref(w1), ctypes.byref(e1))
    if rc != 0:
        return (inflate(data0, size_hint=hint0)[0],
                inflate(data1, size_hint=hint1)[0])
    return (out0[:w0.value].tobytes(), out1[:w1.value].tobytes())


def inflate_into(data, out_buffer, bit_pos: int = 0,
                 window: bytes = b"") -> tuple[int, int, bool]:
    """Inflate INTO a caller-provided writable buffer, zero-copy (the
    known-size fast path, api.lisp:36-48). Returns (n_written, end_bit,
    finished); raises DeflateError('output buffer too small', code 11)
    if the stream needs more room than len(out_buffer)."""
    lib = require()
    dptr, dlen, _keep = _buf(data)
    arr = np.frombuffer(memoryview(out_buffer), np.uint8)
    if not arr.flags.writeable:
        raise TypeError("output buffer must be writable")
    window = bytes(window)
    out_len = ctypes.c_int64()
    end_bit = ctypes.c_int64()
    finished = ctypes.c_int32()
    err = lib.tbz_inflate_into(
        dptr, dlen, bit_pos, window, len(window),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size,
        ctypes.byref(out_len), ctypes.byref(end_bit),
        ctypes.byref(finished))
    if err == ERR_TRUNCATED:
        raise TruncatedError("input underrun")
    if err == ERR_TAPE_OVERFLOW:
        from ..errors import DeflateError
        raise DeflateError("output buffer too small", ERR_TAPE_OVERFLOW)
    raise_for_code(err)
    return int(out_len.value), int(end_bit.value), bool(finished.value)


def pack_tokens(out_len, dist, lit, lit_codes_rev, lit_lens,
                dist_codes_rev, dist_lens, emit_eob: bool,
                init_bits: int, init_nbits: int):
    """Pack a token range with given (bit-reversed) codebooks.
    Returns (packed_bytes, final_bits, final_nbits)."""
    lib = require()
    n = len(out_len)
    ol = np.ascontiguousarray(out_len, np.int32)
    di = np.ascontiguousarray(dist, np.int32)
    li = np.ascontiguousarray(lit, np.int32)
    lcr = np.ascontiguousarray(lit_codes_rev, np.uint32)
    dcr = np.ascontiguousarray(dist_codes_rev, np.uint32)
    ll = np.ascontiguousarray(lit_lens, np.uint8).tobytes()
    dl = np.ascontiguousarray(dist_lens, np.uint8).tobytes()
    cap = n * 6 + 64
    out = np.empty(cap, np.uint8)
    fb = ctypes.c_uint64()
    fn = ctypes.c_int32()
    wrote = lib.tbz_pack(
        _i32p(ol), _i32p(di), _i32p(li), n,
        lcr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), ll,
        dcr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), dl,
        1 if emit_eob else 0, init_bits, init_nbits,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        ctypes.byref(fb), ctypes.byref(fn))
    assert wrote >= 0
    return out[:wrote].tobytes(), int(fb.value), int(fn.value)


def _check_encode_size(data) -> None:
    # frontend.cc hash chains store positions as int32 (head4/head3):
    # past 2^31 every candidate silently fails the distance check and
    # matching degrades to literals, breaking the <=libz invariant.
    # Reject loudly; callers should segment >2GiB inputs.
    if len(data) > 0x7FFFFFFF:
        raise ValueError(
            f"encode input of {len(data)} bytes exceeds the native "
            "matcher's 2GiB limit; segment the input (e.g. "
            "deflate_raw_parallel) instead")


def lz77_match(data, level: int = 6):
    """Native hash-chain lazy matcher. Returns (out_len, dist, lit)."""
    lib = require()
    data = bytes(data)
    _check_encode_size(data)
    cap = len(data) + 1
    out_len = np.empty(cap, np.int32)
    dist = np.empty(cap, np.int32)
    lit = np.empty(cap, np.int32)
    n = lib.tbz_match(data, len(data), level, _i32p(out_len), _i32p(dist),
                      _i32p(lit), cap)
    assert n >= 0, "matcher capacity overflow (impossible: cap=n+1)"
    return out_len[:n].copy(), dist[:n].copy(), lit[:n].copy()


def lz77_match_optimal(data, max_chain: int = 128, iters: int = 2,
                       nice_len: int = 0, sparse: bool = False):
    """Cost-model DP parse (shortest path over actual DEFLATE bit costs,
    refined `iters` times against the parse's own entropy stats).
    nice_len > 0 stops each candidate walk once a match that long is
    found; sparse relaxes only short lengths + breakpoint tops (the
    guarded fast tiers). Returns (out_len, dist, lit)."""
    lib = require()
    data = bytes(data)
    _check_encode_size(data)
    cap = len(data) + 1
    out_len = np.empty(cap, np.int32)
    dist = np.empty(cap, np.int32)
    lit = np.empty(cap, np.int32)
    n = lib.tbz_match_optimal(data, len(data), max_chain, iters, nice_len,
                              1 if sparse else 0,
                              _i32p(out_len), _i32p(dist), _i32p(lit), cap)
    assert n >= 0, "matcher capacity overflow (impossible: cap=n+1)"
    return out_len[:n].copy(), dist[:n].copy(), lit[:n].copy()
