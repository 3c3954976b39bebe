"""Device LZ77 resolver: token tape -> output bytes (the core of
kernel 4), the port of tbz/ops/resolve.py.

The reference materializes bytes inside the sequential decode loop with
an offset-specialized overlapped copy (deflate.lisp:244-359). Here that
dependency chain is re-expressed data-parallel:

  1. exclusive prefix sum of token lengths -> each token's output span;
  2. every byte gets a *parent*: for a match byte, the byte it copies,
     jumping straight to the token's source region
     (tstart - d + (q - tstart) % d, so an overlapping run is one hop);
     literal/stored bytes and the 32 KB carry window point at themselves
     (the window-carry semantics of deflate.lisp:121-137);
  3. pointer doubling (P <- P[P]) to a fixpoint — copies of any depth
     resolve in O(log depth) passes;
  4. one value gather from [window | root bytes].

`_resolve_core` (one tape) and `_resolve_batch` (S tapes, one a row)
launch csrc/resolve.cu for CUDA tensors and run the plain PyTorch
versions for CPU tensors. Both return tbz's number of doubling passes:
an int from the plain version's loop, a 0-d int32 tensor on the card
from the kernel, which runs the same Jacobi passes but skips the bytes
already resolved (reading the count waits for the kernel). The count is
1 + ceil(log2 Dmax), Dmax the most hops from a byte to its root.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _cuda
from .. import constants as C
from ..tape import STORED_FLAG, TokenTape

W = C.MAX_WINDOW  # 32768


def _resolve_from_starts_plain(lens, dist, root_val, starts, input_bytes,
                               window, out_capacity: int):
    """Plain PyTorch resolve of tokens whose (masked) lengths `lens` have
    the exclusive scan `starts`. Returns (uint8[W + cap], passes); bytes
    past the total are 0."""
    dev = lens.device
    T = lens.shape[0]
    lens = lens.long()
    tid = torch.repeat_interleave(torch.arange(T, device=dev), lens)
    q = torch.arange(tid.shape[0], device=dev)
    tstart = starts.long()[tid]
    d = dist.long()[tid]
    rv = root_val.long()[tid]
    j = q - tstart
    n = W + out_capacity
    parent = torch.arange(n, device=dev)
    match = d > 0
    src = (tstart - d + j % d.clamp(min=1) + W).clamp(0, n - 1)
    parent[W + q[match]] = src[match]
    stored = ~match & ((rv & STORED_FLAG) != 0)
    n_in = input_bytes.shape[0]
    off = (rv & (STORED_FLAG - 1)) + j
    sbyte = torch.where(off < n_in,
                        input_bytes.long()[off.clamp(max=max(n_in - 1, 0))],
                        0)
    roots = torch.zeros(out_capacity, dtype=torch.long, device=dev)
    roots[q] = torch.where(match, 0, torch.where(stored, sbyte, rv & 0xFF))
    passes = 0
    while True:
        p2 = parent[parent]
        passes += 1
        changed = bool((p2 != parent).any())
        parent = p2
        if not changed:
            break
    values = torch.cat([window.long(), roots])
    return values[parent].to(torch.uint8), passes


def _resolve_core_plain(out_len, dist, root_val, n_tokens: int,
                        input_bytes, window, out_capacity: int):
    T = out_len.shape[0]
    valid = torch.arange(T, device=out_len.device) < n_tokens
    lens = torch.where(valid, out_len.long(), 0)
    starts = torch.cumsum(lens, 0) - lens
    return _resolve_from_starts_plain(lens, dist, root_val, starts,
                                      input_bytes, window, out_capacity)


def _resolve_core(out_len, dist, root_val, n_tokens: int, input_bytes,
                  window, out_capacity: int):
    """Resolve a token tape (int32[T] each, padded past n_tokens) against
    input bytes (stored runs) and a uint8[W] window.

    Returns (uint8[W + out_capacity], passes): real output is
    [W : W + total_out].

    Kernel (CUDA tensors): csrc/resolve.cu (+ scan.cu). Replaces
    tbz/ops/resolve.py:_resolve_core. Bound: bytes, the tape, stored
    bytes and window read and the output written. Each output byte's
    word (its value, or the distance back to its parent) is written
    once, then one cooperative launch runs tbz's doubling passes over
    the 32-word groups that still hold a pointer and writes the output;
    the pass count is tbz's (see the source note).
    """
    if out_len.device.type == "cpu":
        return _resolve_core_plain(out_len, dist, root_val, n_tokens,
                                   input_bytes, window, out_capacity)
    dev = out_len.device
    T = out_len.shape[0]
    for t in (out_len, dist, root_val):
        if t.dtype != torch.int32:
            raise ValueError("token arrays must be int32")
    if input_bytes.dtype != torch.uint8 or window.dtype != torch.uint8 \
            or window.shape[0] != W:
        raise ValueError("input bytes and window must be uint8 (window W)")
    out = torch.empty(W + out_capacity, dtype=torch.uint8, device=dev)
    lib = _cuda.lib()
    scratch = torch.empty(int(lib.tbz_resolve_scratch_ints(T, out_capacity)),
                          dtype=torch.int32, device=dev)
    _cuda.require_cuda(out_len, dist, root_val, input_bytes, window, out,
                       scratch)
    passes = torch.empty(1, dtype=torch.int32, device=dev)
    _cuda.count("resolve_core")
    _cuda.check(lib.tbz_resolve(
        out_len.data_ptr(), dist.data_ptr(), root_val.data_ptr(),
        int(n_tokens), T, input_bytes.data_ptr(), input_bytes.shape[0],
        window.data_ptr(), out_capacity, out.data_ptr(), scratch.data_ptr(),
        passes.data_ptr(), _cuda.stream(out_len)),
        "resolve_core")
    return out, passes[0]


def _resolve_batch_plain(out_len, dist, root_val, n_tokens, input_bytes,
                         window, out_capacity: int):
    """Plain PyTorch batch resolve: `_resolve_core_plain` row by row.
    Returns (uint8[S, cap], passes), passes the batch's maximum."""
    outs, passes = [], 1
    for r in range(out_len.shape[0]):
        buf, p = _resolve_core_plain(out_len[r], dist[r], root_val[r],
                                     int(n_tokens[r]), input_bytes[r],
                                     window[r], out_capacity)
        outs.append(buf[W:])
        passes = max(passes, p)
    return torch.stack(outs), passes


def _resolve_batch(out_len, dist, root_val, n_tokens, total_out,
                   input_bytes, window, out_capacity: int):
    """Resolve S independent token tapes, one a row: int32[S, T] tapes
    valid below n_tokens[s], total_out[s] output bytes each, stored runs
    read from uint8[S, M] inputs, uint8[S, W] windows.

    Returns (uint8[S, out_capacity], passes): row s holds its output in
    [0, total_out[s]), the window already stripped (tbz/parallel/shard.py:43).
    passes is the batch's: its deepest row's, as tbz's vmapped loop runs.

    Kernel (CUDA tensors): csrc/resolve.cu tbz_resolve_batch. Replaces
    tbz/parallel/shard.py:_resolve_batch (_resolve_impl under vmap).
    Bound: bytes, as _resolve_core's, summed over the rows. The library
    chooses the path by the shape: out_capacity <= onchip_cap() (every
    BGZF bucket) runs one block a row, the row's state in shared memory
    from tape to output, tbz's pass count derived from its deepest chain
    (onchip_rows, no scratch); a larger one scans every row's lengths at
    once (scan.cu) and runs the grid-wide doubling over every row (kernel
    4's). Every launch counts as resolve_batch, and one that the library
    reports on the on-chip path as resolve_onchip too."""
    S, T = out_len.shape
    if S and int(total_out.max()) > out_capacity:
        raise ValueError("a row's output exceeds out_capacity")
    if out_len.device.type == "cpu":
        return _resolve_batch_plain(out_len, dist, root_val, n_tokens,
                                    input_bytes, window, out_capacity)
    dev = out_len.device
    for t in (out_len, dist, root_val, n_tokens):
        if t.dtype != torch.int32:
            raise ValueError("token arrays and counts must be int32")
    if dist.shape != (S, T) or root_val.shape != (S, T) \
            or n_tokens.shape != (S,) or input_bytes.shape[0] != S \
            or window.shape != (S, W):
        raise ValueError("batch shapes disagree")
    if input_bytes.dtype != torch.uint8 or window.dtype != torch.uint8:
        raise ValueError("inputs and windows must be uint8")
    out = torch.empty(S, out_capacity, dtype=torch.uint8, device=dev)
    lib = _cuda.lib()
    scratch = torch.empty(
        int(lib.tbz_resolve_batch_scratch_ints(S, T, out_capacity)),
        dtype=torch.int32, device=dev)
    passes = torch.empty(1, dtype=torch.int32, device=dev)
    _cuda.require_cuda(out_len, dist, root_val, n_tokens, input_bytes,
                       window, out, scratch, passes)
    onchip = ctypes.c_int32(0)
    _cuda.count("resolve_batch")
    err = lib.tbz_resolve_batch(
        out_len.data_ptr(), dist.data_ptr(), root_val.data_ptr(),
        n_tokens.data_ptr(), S, T, input_bytes.data_ptr(),
        input_bytes.shape[1], window.data_ptr(), out_capacity,
        out.data_ptr(), scratch.data_ptr(), passes.data_ptr(),
        ctypes.addressof(onchip), _cuda.stream(out))
    if onchip.value:
        _cuda.count("resolve_onchip")
    _cuda.check(err, "resolve_batch")
    return out, passes[0]


def onchip_cap() -> int:
    """The largest out_capacity that _resolve_batch resolves a row in one
    block's shared memory (csrc/resolve.cu ONCHIP_CAP), for callers that
    pick a shape on either side of it; loads the kernel library."""
    return int(_cuda.lib().tbz_resolve_onchip_cap())


def _pad_pow2(n: int, floor: int = 1024) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


def window_tensor(window, device) -> torch.Tensor:
    """The last W bytes of `window`, right-aligned in a zeroed uint8[W]."""
    win = np.frombuffer(bytes(window), np.uint8)[-W:]
    wpad = np.zeros(W, np.uint8)
    if len(win):
        wpad[W - len(win):] = win
    return torch.from_numpy(wpad).to(device)


def resolve_device(tape: TokenTape, input_bytes, window=b"", device=None,
                   collect_stats: bool = False,
                   out_capacity: int | None = None):
    """Host wrapper: pads to power-of-two shape classes, uploads, runs
    the resolver. Returns (device uint8[W + cap] buffer, total_out)
    (plus the pass count when collect_stats). Callers slice
    [W : W + total_out]. out_capacity: cap (default: total_out rounded
    up to a power of two, at least 4096); ValueError if total_out
    exceeds it."""
    device = torch.device(device or "cuda")
    n = len(tape)
    T = _pad_pow2(n)
    ol = np.zeros(T, np.int32)
    di = np.zeros(T, np.int32)
    rv = np.zeros(T, np.int32)
    ol[:n] = tape.out_len
    di[:n] = tape.dist
    rv[:n] = tape.root_val
    cap = out_capacity or _pad_pow2(tape.total_out, floor=4096)
    if tape.total_out > cap:
        raise ValueError(f"total_out {tape.total_out} exceeds out_capacity "
                         f"{cap}")
    inp = np.frombuffer(bytes(input_bytes), np.uint8)
    if inp.size == 0:
        inp = np.zeros(1, np.uint8)

    def up(a):
        return torch.from_numpy(a).to(device)

    out, passes = _resolve_core(up(ol), up(di), up(rv), n, up(inp.copy()),
                                window_tensor(window, device), cap)
    if collect_stats:
        return out, tape.total_out, int(passes)
    return out, tape.total_out


def resolve_bytes(tape: TokenTape, input_bytes, window: bytes = b"",
                  device=None) -> bytes:
    """Convenience: resolve and fetch to host bytes."""
    out, total = resolve_device(tape, input_bytes, window, device=device)
    return out[W:W + total].cpu().numpy().tobytes()
