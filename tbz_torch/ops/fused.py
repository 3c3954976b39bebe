"""Device-resident fused decode: batched tokenize -> on-device splice ->
pointer-doubling resolve, with ONLY metadata crossing device->host. The
port of tbz/ops/fused.py.

  1. HOST    scan_headers + kernels 1-3 (ops/batched).
  2. D2H     the metadata header ALONE (7L+2B+1 ints): the compacted
             tokens stay on the device.
  3. HOST    the meta-only chain walk (batched._walk) produces a SPLICE
             PLAN — an ordered list of ranges, each either a slice of the
             on-device compact tape or a small host-decoded token run
             (stored blocks, scanner misses, junction gap joins).
  4. H2D     the plan (3 small int32 arrays) + host tokens (3 arrays).
  5. DEVICE  kernel 4 (_splice_resolve): assembles the true token chain
             from the compact tape + host tokens, finds the first bad
             distance (zlib's sequential error order preserved against
             walk-raised structural errors), and resolves LZ77 by pointer
             doubling. Output uint8[4 + W + cap] =
             [first_bad i32 | window | output].

Every stage time in `stats` is taken after a device synchronize, so the
stages sum to the call's wall time.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _cuda
from .. import errors as E
from . import batched as B
from .resolve import W, _pad_pow2, _resolve_from_starts_plain, window_tensor

_BIG = 2**31 - 1


class _PlanBuilder:
    """Collects the walk's emits into a range plan + host token arrays,
    tracking token-chain position and output bytes (meta.nbytes sizes the
    device ranges without touching token values)."""

    def __init__(self, meta):
        self.meta = meta
        self.dst: list = []     # (dst_start, src_start, kind)
        self.n_tok = 0          # token-chain length so far
        self.n_bytes = 0        # output bytes so far
        self.h_ol: list = []
        self.h_di: list = []
        self.h_rv: list = []
        self.n_host = 0

    def emit_dev(self, lane, a, b):
        # coalesce ranges contiguous in BOTH chain and compact space
        if not (self.dst and self.dst[-1][2] == 0
                and self.dst[-1][1] + (self.n_tok - self.dst[-1][0]) == a):
            self.dst.append((self.n_tok, a, 0))
        self.n_tok += b - a
        self.n_bytes += int(self.meta.nbytes[lane])

    def emit_host(self, ol, di, rv):
        if len(ol) == 0:
            return
        if not (self.dst and self.dst[-1][2] == 1
                and self.dst[-1][1] + (self.n_tok - self.dst[-1][0])
                == self.n_host):
            self.dst.append((self.n_tok, self.n_host, 1))
        self.h_ol.append(ol)
        self.h_di.append(di)
        self.h_rv.append(rv)
        self.n_tok += len(ol)
        self.n_host += len(ol)
        self.n_bytes += int(ol.astype(np.int64).sum())


class SpliceInputs(NamedTuple):
    """Kernel 4's uploaded inputs and shape classes."""
    rng_dst: torch.Tensor   # int32[R]; padding ranges carry dst = T
    rng_src: torch.Tensor
    rng_kind: torch.Tensor  # 0: compact tape, 1: host tokens
    host_ol: torch.Tensor   # int32[H]
    host_di: torch.Tensor
    host_rv: torch.Tensor
    window: torch.Tensor    # uint8[W], right-aligned
    n_total: int            # token-chain length
    window_len: int
    T: int
    cap: int


def splice_inputs_from_numpy(pb, window, device) -> SpliceInputs:
    """Pad and upload a splice plan: `pb` is any object with
    _PlanBuilder's fields (this module's, or tbz.ops.fused._PlanBuilder
    as the parity tests pass it)."""
    n_total = pb.n_tok
    T = _pad_pow2(max(n_total, 1))
    R = _pad_pow2(max(len(pb.dst), 1), floor=64)
    H = _pad_pow2(max(pb.n_host, 1), floor=64)
    cap = _pad_pow2(pb.n_bytes, floor=4096)
    rng = np.zeros((3, R), np.int32)
    rng[0, :] = T  # padding ranges sort after every chain slot
    for r, (d, s, k) in enumerate(pb.dst):
        rng[:, r] = d, s, k
    host = np.zeros((3, H), np.int32)
    if pb.n_host:
        host[0, :pb.n_host] = np.concatenate(pb.h_ol)
        host[1, :pb.n_host] = np.concatenate(pb.h_di)
        host[2, :pb.n_host] = np.concatenate(pb.h_rv)
    rng_t = torch.from_numpy(rng).to(device)
    host_t = torch.from_numpy(host).to(device)
    win_len = min(len(bytes(window)), W)
    return SpliceInputs(rng_t[0], rng_t[1], rng_t[2], host_t[0], host_t[1],
                        host_t[2], window_tensor(window, device), n_total,
                        win_len, T, cap)


def _splice_resolve_plain(compact, input_bytes, si: SpliceInputs):
    """Plain PyTorch splice + distance check + resolve (the arithmetic of
    tbz/ops/fused.py:_splice_resolve)."""
    dev = compact.device
    T = si.T
    i = torch.arange(T, device=dev)
    valid = i < si.n_total
    R = si.rng_dst.shape[0]
    dst = si.rng_dst.long()
    rid = (torch.searchsorted(dst, i, right=True) - 1).clamp(0, R - 1)
    pos = si.rng_src.long()[rid] + (i - dst[rid])
    from_host = si.rng_kind[rid] == 1
    tok = compact.long()[torch.where(~from_host & valid, pos, 0)
                         .clamp(0, compact.shape[0] - 1)]
    hi = torch.where(from_host, pos, 0).clamp(0, si.host_ol.shape[0] - 1)
    ln_d = tok & 0x1FF
    fld = tok >> 9
    is_lit = ln_d == 1
    ol = torch.where(valid, torch.where(from_host, si.host_ol.long()[hi],
                                        ln_d), 0)
    di = torch.where(valid & (ol > 0),
                     torch.where(from_host, si.host_di.long()[hi],
                                 torch.where(is_lit, 0, fld + 1)), 0)
    rv = torch.where(valid, torch.where(from_host, si.host_rv.long()[hi],
                                        torch.where(is_lit, fld, 0)), 0)
    pref = torch.cumsum(ol, 0) - ol
    bad = (di > pref + si.window_len) & (di > 0)
    first_bad = torch.where(bad, i, _BIG).min().to(torch.int32)
    buf, passes = _resolve_from_starts_plain(ol, di, rv, pref, input_bytes,
                                             si.window, si.cap)
    return torch.cat([first_bad.reshape(1).view(torch.uint8), buf]), passes


def _splice_resolve(compact, input_bytes, si: SpliceInputs):
    """Token-chain assembly + distance check + resolve (kernel 4).

    compact: int32[n_out + 1] on-device token tape (batched layout);
    input_bytes: uint8 staged payload (stored runs read from it).
    Returns (uint8[4 + W + cap] = [first_bad i32 | window | output],
    passes): passes an int (plain) or a 0-d int32 tensor on the card.

    Kernel (CUDA tensors): csrc/splice.cu + resolve.cu + scan.cu, on the
    chain's n_total slots only. Replaces tbz/ops/fused.py:_splice_resolve.
    Bound: bytes; the doubling passes of the resolve dominate (see the
    source notes)."""
    if compact.device.type == "cpu":
        return _splice_resolve_plain(compact, input_bytes, si)
    dev = compact.device
    out = torch.empty(4 + W + si.cap, dtype=torch.uint8, device=dev)
    lib = _cuda.lib()
    scratch = torch.empty(int(lib.tbz_splice_scratch_ints(si.T, si.cap)),
                          dtype=torch.int32, device=dev)
    _cuda.require_cuda(compact, input_bytes, si.rng_dst, si.rng_src,
                       si.rng_kind, si.host_ol, si.host_di, si.host_rv,
                       si.window, out, scratch)
    if compact.dtype != torch.int32 or input_bytes.dtype != torch.uint8:
        raise ValueError("compact must be int32 and input bytes uint8")
    passes = torch.empty(1, dtype=torch.int32, device=dev)
    # one call launches the splice kernel and resolve.cu's doubling passes
    # (tbz's _splice_resolve runs _resolve_core after the splice)
    _cuda.count("splice_resolve")
    _cuda.count("resolve_core")
    _cuda.check(lib.tbz_splice_resolve(
        compact.data_ptr(), compact.shape[0], si.rng_dst.data_ptr(),
        si.rng_src.data_ptr(), si.rng_kind.data_ptr(), si.rng_dst.shape[0],
        si.host_ol.data_ptr(), si.host_di.data_ptr(), si.host_rv.data_ptr(),
        si.host_ol.shape[0], si.n_total, si.window_len, si.T,
        input_bytes.data_ptr(), input_bytes.shape[0], si.window.data_ptr(),
        si.cap, out.data_ptr(), scratch.data_ptr(),
        passes.data_ptr(), _cuda.stream(compact)), "splice_resolve")
    return out, passes[0]


def decode_stream_fused(data: bytes, window: bytes = b"",
                        chunk_bits: int = 8192, fetch: bool = True,
                        collect_stats: bool = False, device=None):
    """Whole-stream decode on `device` (default cuda).

    Returns (out_bytes, dev_body uint8[cap], total, end_bit[, stats]);
    with fetch=False out_bytes is None and only the 4-byte error word
    crosses to the host after the metadata (device-resident consumers
    slice dev_body[:total]). Returns None when the stream has no dynamic-block candidates, is
    under 256 bytes or is too large for int32 coordinates, so that the
    caller takes the host-tokenizer route. Raises the native library's
    build error if it did not build. Raises the canonical frontend
    errors with zlib's sequential ordering: a bad distance in
    already-emitted tokens outranks any structural error the walk hits
    later in the stream."""
    device = torch.device(device or "cuda")
    data = bytes(data)
    nbits = len(data) * 8
    if nbits >= (1 << 31) or len(data) < 256:
        return None

    stats = B._new_stats()
    scan, plan, flat, data32 = B._scan_and_launch(data, chunk_bits, stats,
                                                  device)
    if scan is None:
        return None

    # D2H #1: metadata header ONLY — the token tape stays on the device
    hdr_len = plan.hdr_len
    t0 = time.perf_counter()
    meta = B._parse_meta(flat[:hdr_len].cpu().numpy(), plan)
    stats["fetch_ms"] = (time.perf_counter() - t0) * 1e3
    stats["fetches"] = 1
    stats["meta_d2h_bytes"] = 4 * hdr_len

    pb = _PlanBuilder(meta)
    t0 = time.perf_counter()
    walk_err = None
    end_bit = None
    try:
        end_bit = B._walk(data, scan, plan, meta, stats,
                          pb.emit_dev, pb.emit_host)
    except E.DeflateError as e:   # includes TruncatedError
        walk_err = e
    stats["walk_ms"] = (time.perf_counter() - t0) * 1e3

    # ---- upload the splice plan, run kernel 4 ----
    t0 = time.perf_counter()
    if walk_err is not None and pb.n_tok == 0:
        raise walk_err
    if pb.n_bytes >= (1 << 31):
        return None  # int32 coordinate space; caller falls back
    si = splice_inputs_from_numpy(pb, window, device)
    compact = flat[hdr_len:hdr_len + plan.n_out + 1]
    ret, passes = _splice_resolve(compact, data32.view(torch.uint8), si)
    B.sync(device)
    stats["resolve_ms"] = (time.perf_counter() - t0) * 1e3
    if collect_stats:
        stats["passes"] = int(passes)

    # ---- fetch: error word (+ output when fetch and the walk succeeded)
    # in ONE D2H
    t0 = time.perf_counter()
    total = pb.n_bytes
    if fetch and walk_err is None:
        head = ret[:4 + W + total].cpu().numpy()
        first_bad = int(head[:4].view(np.int32)[0])
        out = head[4 + W:].tobytes()
        stats["out_d2h_bytes"] = head.size
    else:
        first_bad = int(ret[:4].cpu().numpy().view(np.int32)[0])
        out = None
        stats["out_d2h_bytes"] = 4
    stats["out_fetch_ms"] = (time.perf_counter() - t0) * 1e3
    if first_bad < si.n_total:
        E.raise_for_code(E.ERR_BAD_DISTANCE)
    if walk_err is not None:
        raise walk_err
    dev_body = ret[4 + W:]
    if collect_stats:
        return out, dev_body, total, end_bit, stats
    return out, dev_body, total, end_bit
