"""ctypes loader for the native host runtime (frontend.cc, a copy of
tbz's).

Compiled on demand with g++ into tbz_torch/native/build/ (cache keyed on
source mtime). Binds what the port's decode uses: the tokenizer, the
single-pass inflate (host backend), the speculative header scanner, the
mid-block gap decoder (the batched decode's chain walk) and the flat
span planner (the declined-stream resolve, ops/resolve_spans).
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
