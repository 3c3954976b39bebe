"""Device LZ77 span resolver (flat form), the port of
tbz/ops/resolve_spans.py: the resolve of every stream that the fused
decode declines.

The C++ planner (native/frontend.cc tbz_plan_spans_flat) pre-fills
literal and stored bytes straight into the output rows on the host,
decomposes overlapping copies into doubling pieces, flattens copy
genealogies, chops every span at the 128-byte rows of both its source
and its destination, and list-schedules the spans into dependency-safe
batches of G row-groups x K slots, grouped into segments of seg_rows
rows. The device table is [256 window rows | output rows]; a slot
(srcaddr, o, ln) copies table bytes [srcaddr, srcaddr + ln) to
[(base + g_row) * 128 + o, ... + ln) of its batch's segment.

tbz does that with one row gather, a barrel rotate, a byte mask and a
scatter-add into a segment accumulator per slot, the TPU's fast path.
The planner guarantees that the rotate never wraps, that contributions
never overlap a prefilled byte or each other, and that a batch reads
only bytes that are final before it. So every written byte has one
parent, the plan is a forest, and on the card the whole plan is
resolved at once by pointer doubling (csrc/spans.cu, with
csrc/resolve.cu's doubling).

`_resolve_flat_impl` launches the kernel for CUDA tensors and runs the
plain PyTorch version for CPU tensors. `_resolve_flat_scan_impl` and
`_resolve_flat_gscat_impl` take tbz's two other argument layouts of the
same function (its test baselines: a segment row per batch, or absolute
target rows) and run the same kernel: a run of equal segment rows is a
segment, and absolute rows are one segment based at table row 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _cuda

W_ROWS = 256  # 32 KB window, prepended to the output table as rows
W = W_ROWS * 128


class FlatArgs(NamedTuple):
    """The flat resolver's arguments: the slot arrays and the prefilled
    output and window on the device, the segment table on the host (the
    wrapper turns it into one segment base a batch)."""
    srcaddr: torch.Tensor    # int32[NB, G, K] table byte address
    lenoff: torch.Tensor     # int16[NB, G, K] = o << 8 | ln
    g_rows: torch.Tensor     # int32[NB, G] row relative to the segment base
    seg_lo: np.ndarray       # int32[S] each segment's batch range
    seg_hi: np.ndarray
    seg_base: np.ndarray     # int32[S] its base table row
    out0: torch.Tensor       # uint8[n_rows_out * 128] prefilled output
    window: torch.Tensor     # uint8[W], right-aligned


def stage_flat_plan(plan, window: bytes = b""):
    """Stage a host FlatPlan into _resolve_flat_impl's numpy arguments
    (srcaddr, lenoff, g_rows, seg_lo, seg_hi, seg_base, out0 u8, window
    u8). Unlike tbz (XLA compiles one kernel a shape), the batch, segment
    and row counts are not padded: one library serves every shape."""
    NB, G, K = plan.n_batches, plan.G, plan.K
    srcaddr = np.ascontiguousarray(plan.srcaddr, np.int32).reshape(NB, G, K)
    lenoff = np.ascontiguousarray(plan.lenoff, np.int16).reshape(NB, G, K)
    g_rows = np.ascontiguousarray(plan.g_row, np.int32).reshape(NB, G)
    # runs of equal b_segrow become [seg_lo, seg_hi) batch ranges
    bs = np.asarray(plan.b_segrow, np.int32)
    starts = np.flatnonzero(np.r_[True, bs[1:] != bs[:-1]]) if NB else \
        np.zeros(0, np.int64)
    seg_base = bs[starts].astype(np.int32)
    seg_lo = starts.astype(np.int32)
    seg_hi = np.r_[starts[1:], NB].astype(np.int32) if NB else \
        np.zeros(0, np.int32)
    out0 = np.asarray(plan.out0, np.uint8)  # ceil(total / 128) rows
    w8 = np.zeros(W, np.uint8)
    if window:
        w = np.frombuffer(bytes(window)[-W:], np.uint8)
        w8[W - len(w):] = w
    return (srcaddr, lenoff, g_rows, seg_lo, seg_hi, seg_base, out0, w8)


def flat_plan_from_numpy(args, device) -> FlatArgs:
    """Upload staged flat-plan arguments: `args` is this module's
    stage_flat_plan tuple or tbz.ops.resolve_spans.stage_flat_plan's
    (padded, with uint32 word rows), as the parity tests pass it."""
    srcaddr, lenoff, g_rows, seg_lo, seg_hi, seg_base, out0, wrows = args

    def up(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)

    return FlatArgs(up(srcaddr, np.int32), up(lenoff, np.int16),
                    up(g_rows, np.int32),
                    np.ascontiguousarray(seg_lo, np.int32),
                    np.ascontiguousarray(seg_hi, np.int32),
                    np.ascontiguousarray(seg_base, np.int32),
                    up(np.ascontiguousarray(out0).view(np.uint8).reshape(-1),
                       np.uint8),
                    up(np.ascontiguousarray(wrows).view(np.uint8).reshape(-1),
                       np.uint8))


def _resolve_flat_plain(a: FlatArgs):
    """Plain PyTorch flat resolve: tbz's segment and batch loops
    (tbz/ops/resolve_spans.py:146-203), each slot a masked copy of its
    source bytes. Returns the output rows as uint8[n_rows_out * 128]."""
    dev = a.out0.device
    NB, G, K = a.srcaddr.shape
    table = torch.cat([a.window, a.out0])
    j = torch.arange(128, device=dev)
    for s in range(len(a.seg_base)):
        base = int(a.seg_base[s])
        for b in range(int(a.seg_lo[s]), int(a.seg_hi[s])):
            sa = a.srcaddr[b].reshape(-1).long()
            lo = a.lenoff[b].reshape(-1).long()
            ln = lo & 255
            live = ln > 0
            o = ((lo >> 8) & 127)[live]
            gr = a.g_rows[b].long().repeat_interleave(K)[live]
            sa, ln = sa[live], ln[live]
            m = j[None, :] < ln[:, None]
            src = (sa[:, None] + j)[m]
            dst = ((base + gr) * 128 + o)[:, None] + j
            table[dst[m]] = table[src]
    return table[W:]


def _batch_bases(a: FlatArgs) -> np.ndarray:
    """Each batch's segment base row from the host segment table, -1 for
    a batch in no segment (tbz's shape padding, never run)."""
    NB = a.srcaddr.shape[0]
    seg = (a.seg_lo, a.seg_hi, a.seg_base)
    if any(x.dtype != np.int32 or not x.flags.c_contiguous
           or x.shape != a.seg_base.shape for x in seg) \
            or np.any(a.seg_lo < 0) or np.any(a.seg_lo > a.seg_hi) \
            or np.any(a.seg_hi > NB):
        raise ValueError("segment table: int32[S] each, batch ranges in "
                         "[0, NB)")
    base = np.full(max(NB, 1), -1, np.int32)
    for lo, hi, b in zip(a.seg_lo.tolist(), a.seg_hi.tolist(),
                         a.seg_base.tolist()):
        if lo < hi and base[lo:hi].max() >= 0:
            raise ValueError("segment table: a batch lies in two segments")
        base[lo:hi] = b
    return base


def _resolve_flat_impl(a: FlatArgs):
    """Resolve the flat plan: returns the output rows, uint8[n_rows_out *
    128] (window stripped; bytes [0, total_out) are the stream's).

    Kernel (CUDA tensors): csrc/spans.cu, three launches for the whole
    plan: the table as root words, every slot's bytes as pointers to
    their sources, then resolve.cu's doubling kernel and its output pass
    (the planner makes the plan a forest, so no batch order is needed). Replaces tbz/ops/resolve_spans.py:145 _resolve_flat_impl
    (with :56 _barrel_contrib). Bound: bytes, the prefilled rows and the
    slot arrays read, the output written (see the source note)."""
    if a.out0.device.type == "cpu":
        return _resolve_flat_plain(a)
    dev = a.out0.device
    NB, G, K = a.srcaddr.shape
    if a.srcaddr.dtype != torch.int32 or a.lenoff.dtype != torch.int16 \
            or a.g_rows.dtype != torch.int32 or a.g_rows.shape != (NB, G):
        raise ValueError("flat plan arrays: int32 srcaddr/g_rows, int16 "
                         "lenoff, matching (NB, G, K)")
    if a.window.shape != (W,) or a.out0.dtype != torch.uint8 \
            or a.lenoff.shape != a.srcaddr.shape:
        raise ValueError("window must be uint8[32768], out0 uint8, and "
                         "lenoff shaped as srcaddr")
    # the segment table lives on the host: one int32 a batch goes up
    # through pinned memory, without waiting for the stream
    base = torch.from_numpy(_batch_bases(a)).pin_memory().to(
        dev, non_blocking=True)
    n_out = a.out0.numel()
    out = torch.empty(n_out, dtype=torch.uint8, device=dev)
    lib = _cuda.lib()
    scratch = torch.empty(int(lib.tbz_resolve_flat_scratch_ints(n_out)),
                          dtype=torch.int32, device=dev)
    _cuda.require_cuda(a.srcaddr, a.lenoff, a.g_rows, a.out0, a.window,
                       base, out, scratch)
    _cuda.count("resolve_flat")
    _cuda.check(lib.tbz_resolve_flat(
        a.srcaddr.data_ptr(), a.lenoff.data_ptr(), a.g_rows.data_ptr(), NB,
        G, K, base.data_ptr(), a.window.data_ptr(), a.out0.data_ptr(),
        n_out, out.data_ptr(), scratch.data_ptr(), _cuda.stream(out)),
        "resolve_flat")
    return out


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _baseline_args(srcaddr, lenoff, g_rows, seg_lo, seg_hi, seg_base, out0,
                   window_rows, n_rows_out: int, device) -> FlatArgs:
    """tbz's (NB, G, K) slot arrays, uint32 (n_rows_out, 32) out0 and
    (256, 32) window rows (numpy arrays or tensors) with a segment
    table, uploaded to the device of `srcaddr` when it is a tensor, else
    to `device` (default cuda)."""
    if isinstance(srcaddr, torch.Tensor):
        device = srcaddr.device
    out0, window_rows = _host(out0), _host(window_rows)
    if out0.shape != (n_rows_out, 32) or window_rows.shape != (W_ROWS, 32):
        raise ValueError("out0 must be (n_rows_out, 32) and window_rows "
                         "(256, 32) word rows")
    return flat_plan_from_numpy(
        (_host(srcaddr), _host(lenoff), _host(g_rows), seg_lo, seg_hi,
         seg_base, out0, window_rows), torch.device(device or "cuda"))


def _resolve_flat_scan_impl(srcaddr, lenoff, g_rows, b_segrow, out0,
                            window_rows, n_rows_out: int, seg_rows: int, *,
                            device=None):
    """tbz's scan-over-batches layout (tbz/ops/resolve_spans.py:90):
    g_rows (NB, G) relative to each batch's segment row b_segrow (NB,),
    shape-padding batches included. Runs of equal b_segrow become the
    segments, as stage_flat_plan makes them; a batch's live groups must
    target rows in [0, seg_rows) of its segment. Returns the output rows
    as uint8[n_rows_out * 128], as _resolve_flat_impl does."""
    bs = _host(b_segrow).astype(np.int32)
    g = _host(g_rows)
    live = ((_host(lenoff).astype(np.int32) & 255) > 0).any(axis=-1)
    if bs.shape != g.shape[:1] or live.shape != g.shape or \
            np.any((g[live] < 0) | (g[live] >= seg_rows)):
        raise ValueError("one b_segrow a batch; live g_rows in "
                         "[0, seg_rows)")
    starts = np.flatnonzero(np.r_[True, bs[1:] != bs[:-1]]) if len(bs) \
        else np.zeros(0, np.int64)
    return _resolve_flat_impl(_baseline_args(
        srcaddr, lenoff, g, starts.astype(np.int32),
        np.r_[starts[1:], len(bs)].astype(np.int32), bs[starts], out0,
        window_rows, n_rows_out, device))


def _resolve_flat_gscat_impl(srcaddr, lenoff, g_rows_g, out0, window_rows,
                             n_rows_out: int, *, device=None):
    """tbz's global-scatter layout (tbz/ops/resolve_spans.py:120): g_rows_g
    (NB, G) absolute table rows. One segment of every batch, based at
    table row 0. Returns uint8[n_rows_out * 128]."""
    NB = len(_host(g_rows_g))
    one = np.zeros(1, np.int32)
    return _resolve_flat_impl(_baseline_args(
        srcaddr, lenoff, g_rows_g, one, np.full(1, NB, np.int32), one,
        out0, window_rows, n_rows_out, device))


def resolve_flat_device(tape, input_bytes, window: bytes = b"",
                        G: int = 4096, K: int = 4, seg_rows: int = 16384,
                        device=None):
    """Plan on the host (C++ flat planner), resolve on `device` (default
    cuda). Returns (uint8 tensor on the device holding the output rows,
    window stripped, total_out). Raises ValueError for outputs of 2 GB -
    64 KB and more (int32 table addresses)."""
    from ..native import loader
    device = torch.device(device or "cuda")
    plan = loader.plan_spans_flat(tape, input_bytes,
                                  window_len=len(window), G=G, K=K,
                                  seg_rows=seg_rows)
    args = flat_plan_from_numpy(stage_flat_plan(plan, window), device)
    return _resolve_flat_impl(args), plan.total_out


def resolve_flat_bytes(tape, input_bytes, window: bytes = b"",
                       G: int = 4096, K: int = 4, seg_rows: int = 16384,
                       device=None) -> bytes:
    """Convenience: flat-resolve and fetch to host bytes."""
    out, total = resolve_flat_device(tape, input_bytes, window, G=G, K=K,
                                     seg_rows=seg_rows, device=device)
    return out[:total].cpu().numpy().tobytes()
