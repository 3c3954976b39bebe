"""Row-gather probes, the port of the four Pallas kernels of the closed
TPU probe scripts/pallas_spike_r3.py: the yardstick of the row gather
that the flat span resolver is built on.

A table is R rows of 32 uint32 words (128 bytes), held in an int32[R, 32]
tensor with the same bits (torch's uint32 lacks most operations); index
vectors are int32[N]. Rows whose index lies outside the table, and (for
accum_rows) rows whose destination lies outside the output, move
nothing: their output row is zero.

- copy_rows(idx, tbl):       out[i] = tbl[idx[i]]                (:39)
- rot_rows(idx, rot, tbl):   out[i] = tbl[idx[i]] rotated left by
                             rot[i] mod 32 words (:47; the spike passes
                             its byte rotation // 4)
- accum_rows(idx, dst, tbl): out = 0; out[dst[i]] += tbl[idx[i]] mod
                             2^32, N output rows (:59)
- grid_rows(idx, tbl):       copy_rows's function, as run_grid's `kern`
                             (:179) computes it: one grid step a row.

On a CUDA tensor each wrapper launches its kernel (csrc/rowgather.cu)
and counts the launch; on a CPU tensor it runs the plain PyTorch version
beside it. copy_rows and grid_rows are two designs of one function, as
in the spike: copy_rows gathers through the load/store units (eight
lanes a row in 16-byte vectors, eight rows in flight a thread), grid_rows
through Hopper's bulk-copy engine (a cp.async.bulk a row into a ring of
shared-memory tiles, one bulk store a tile: the spike's one row DMA a
grid step). Each keeps its own counter and its own row in PERF.md's
kernel table. rot_rows is copy_rows' kernel with a rotation inside each
row's 8 lanes; accum_rows sorts the valid rows by dst (two levels of
counting sort, the second in shared memory; a cooperative launch a
round of 2^23 output rows) and writes each output row once, the sum of
its bucket's table rows.

    python -m tbz_torch.ops.rowgather {copy|rot|accum|grid} [N] [R]

runs one probe on the card as the spike's run_* does (defaults N=8192,
R=4096): seeded inputs, the result checked against numpy, the time from
CUDA events, and M rows/s; then the kernel alone (torch.profiler's
device time of one call), the host time of each piece of the wrapper's
glue a call, and, for copy and grid, index_select's time, alone and
(among the glue) on the host.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import _cuda

WORDS = 32  # uint32 words a row (128 bytes)
_INT32 = torch.int32


def _check(tbl, *vecs) -> bool:
    """Every wrapper's one validation pass: types, shapes, one device
    (compared by index, -1 on the CPU: cheaper than device objects).
    True for CPU tensors (the plain version's case)."""
    s = tbl.shape
    if tbl.dtype is not _INT32 or len(s) != 2 or s[1] != WORDS or s[0] < 1:
        raise ValueError("table must be int32[R, 32] with R >= 1")
    n, dev = vecs[0].shape, tbl.get_device()
    for v in vecs:
        if v.dtype is not _INT32 or len(n) != 1 or v.shape != n:
            raise ValueError("index vectors must be int32[N], one length")
        if v.get_device() != dev:
            raise ValueError(f"input on {v.device}, table on {tbl.device}")
    return tbl.is_cpu


# --- plain PyTorch versions (CPU tensors; the card's yardstick) -------------

def _copy_rows_plain(idx, tbl):
    i = idx.long()
    ok = (i >= 0) & (i < tbl.shape[0])
    rows = tbl[i.clamp(0, tbl.shape[0] - 1)]
    return torch.where(ok[:, None], rows, 0)


def _rot_rows_plain(idx, rot, tbl):
    cols = (torch.arange(WORDS, device=tbl.device) + rot.long()[:, None]) \
        % WORDS
    return torch.gather(_copy_rows_plain(idx, tbl), 1, cols)


def _accum_rows_plain(idx, dst, tbl):
    """index_add_ in int64, then masked to 32 bits."""
    N = idx.shape[0]
    i, d = idx.long(), dst.long()
    ok = (i >= 0) & (i < tbl.shape[0]) & (d >= 0) & (d < N)
    acc = torch.zeros(N, WORDS, dtype=torch.long, device=tbl.device)
    acc.index_add_(0, d[ok], tbl[i[ok]].long() & 0xFFFFFFFF)
    acc &= 0xFFFFFFFF
    return torch.where(acc >= 1 << 31, acc - (1 << 32), acc).to(torch.int32)


# --- kernel wrappers --------------------------------------------------------

_entries: dict = {}   # kernel name -> its C entry, looked up once


def accum_scratch_ints(N: int) -> int:
    """int32 scratch of tbz_accum_rows at N rows (csrc/rowgather.cu's
    accum_scratch_ints: 24580 for the coarse buckets' starts, cursors
    and pieces, then the valid rows' (idx, dst) pairs)."""
    return 2 * N + 24580


def _launch(name: str, tbl, *vecs, scratch=None):
    """tbz_<name>(*vecs, N, tbl, R, out[, ws, ws_ints], stream) on
    tensors that _check passed: int32[N, 32], the launch counted (none at
    N = 0). scratch(N): the int32 scratch the entry takes, if any."""
    if not tbl.is_cuda:
        raise ValueError(f"kernel input on {tbl.device}, expected cuda")
    if not tbl.is_contiguous():
        tbl = tbl.contiguous()
    vecs = [v.contiguous() for v in vecs]   # self if contiguous; a copy
    ptrs = [v.data_ptr() for v in vecs]      # lives until the launch
    N = vecs[0].shape[0]
    out = tbl.new_empty(N, WORDS)
    if N:
        fn = _entries.get(name)
        if fn is None:
            fn = _entries[name] = getattr(_cuda.lib(), "tbz_" + name)
        args = (*ptrs, N, tbl.data_ptr(), tbl.shape[0], out.data_ptr())
        if scratch is not None:
            ws = tbl.new_empty(scratch(N))   # lives until the launch
            args += (ws.data_ptr(), ws.numel())
        _cuda.count(name)
        _cuda.check(fn(*args, _cuda.stream(out)), name)
    return out


def copy_rows(idx, tbl):
    """out[i] = tbl[idx[i]]: int32[N, 32]. Kernel (CUDA tensors):
    csrc/rowgather.cu, eight lanes a row in 16-byte vectors, eight rows
    in flight a thread. Replaces scripts/pallas_spike_r3.py:39
    _copy_kernel. Bound: bytes."""
    if _check(tbl, idx):
        return _copy_rows_plain(idx, tbl)
    return _launch("copy_rows", tbl, idx)


def grid_rows(idx, tbl):
    """copy_rows's function through the bulk-copy engine: a cp.async.bulk
    a row into a ring of shared-memory tiles, a bulk store a tile.
    Replaces scripts/pallas_spike_r3.py:179 `kern` of run_grid. Bound:
    bytes."""
    if _check(tbl, idx):
        return _copy_rows_plain(idx, tbl)
    return _launch("grid_rows", tbl, idx)


def rot_rows(idx, rot, tbl):
    """out[i][w] = tbl[idx[i]][(w + rot[i]) mod 32]: int32[N, 32]. Kernel
    (CUDA tensors): csrc/rowgather.cu, copy_rows' kernel (16-byte loads,
    eight rows in flight a thread) with each row rotated across its eight
    lanes by two 16-byte shuffles and a select. Replaces
    scripts/pallas_spike_r3.py:47 _rot_kernel. Bound: bytes."""
    if _check(tbl, idx, rot):
        return _rot_rows_plain(idx, rot, tbl)
    return _launch("rot_rows", tbl, idx, rot)


def accum_rows(idx, dst, tbl):
    """out = 0; out[dst[i]] += tbl[idx[i]] mod 2^32: int32[N, 32]. Kernel
    (CUDA tensors): csrc/rowgather.cu, a cooperative launch (one a round
    of 2^23 output rows) that sorts the valid rows by dst in a scratch of
    accum_scratch_ints(N) int32 and writes each output row once, the sum
    of its bucket's rows (exact: integer adds commute). Replaces scripts/pallas_spike_r3.py:59
    _accum_kernel. Bound: bytes."""
    if _check(tbl, idx, dst):
        return _accum_rows_plain(idx, dst, tbl)
    return _launch("accum_rows", tbl, idx, dst, scratch=accum_scratch_ints)


PROBES = ("copy", "rot", "accum", "grid")


def probe_inputs(which: str, N: int, R: int) -> dict:
    """The spike's seeded inputs of run_<which> (numpy; tbl uint32)."""
    if which in ("copy", "grid"):
        return dict(idx=np.random.default_rng(0).integers(0, R, N)
                    .astype(np.int32),
                    tbl=np.random.default_rng(1).integers(
                        0, 2**32, (R, WORDS), dtype=np.uint32))
    rng = np.random.default_rng(0)
    idx = rng.integers(0, R, N).astype(np.int32)
    if which == "rot":
        rot = rng.integers(0, WORDS, N).astype(np.int32)  # in words
        return dict(idx=idx, rot=rot, tbl=rng.integers(
            0, 2**32, (R, WORDS), dtype=np.uint32))
    if which == "accum":
        dst = rng.integers(0, N, N).astype(np.int32)
        return dict(idx=idx, dst=dst, tbl=rng.integers(
            0, 2**20, (R, WORDS), dtype=np.uint32))
    raise ValueError(f"probe must be one of {PROBES}")


def expected(which: str, inp: dict) -> np.ndarray:
    """The spike's numpy result of run_<which>, uint32[N, 32]."""
    rows = inp["tbl"][inp["idx"]]
    if which in ("copy", "grid"):
        return rows
    if which == "rot":
        cols = (np.arange(WORDS) + inp["rot"][:, None]) % WORDS
        return np.take_along_axis(rows, cols, axis=1)
    # accum: sum the rows of each destination (sorted, reduceat), mod 2^32
    dst = inp["dst"]
    order = np.argsort(dst, kind="stable")
    ds = dst[order]
    starts = np.flatnonzero(np.r_[True, ds[1:] != ds[:-1]])
    out = np.zeros((len(dst), WORDS), np.uint64)
    if len(dst):
        out[ds[starts]] = np.add.reduceat(
            rows[order].astype(np.uint64), starts, axis=0)
    return (out & 0xFFFFFFFF).astype(np.uint32)


def to_tensors(inp: dict, device) -> dict:
    """probe_inputs' arrays as int32 tensors on `device`."""
    return {k: torch.from_numpy(v.view(np.int32)).to(device)
            for k, v in inp.items()}


def call(which: str, t: dict):
    """The wrapper of probe `which` on the tensors of to_tensors."""
    if which == "copy":
        return copy_rows(t["idx"], t["tbl"])
    if which == "grid":
        return grid_rows(t["idx"], t["tbl"])
    if which == "rot":
        return rot_rows(t["idx"], t["rot"], t["tbl"])
    return accum_rows(t["idx"], t["dst"], t["tbl"])


def probe(which: str, N: int = 8192, R: int = 4096, device="cuda",
          reps: int = 3) -> dict:
    """run_<which> of the spike: seeded inputs, the result checked
    against numpy (AssertionError if wrong), then `reps` calls timed with
    CUDA events after a synchronize (the host clock on the CPU). Returns
    {"ms": mean ms a call, "Mrows_s": N / ms / 1e3}."""
    dev = torch.device(device)
    inp = probe_inputs(which, N, R)
    t = to_tensors(inp, dev)
    out = call(which, t)
    if not np.array_equal(out.cpu().numpy().view(np.uint32),
                          expected(which, inp)):
        raise AssertionError(f"{which}_rows WRONG RESULT")
    call(which, t)   # warm the card up again after the host-side check
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            call(which, t)
        ev[1].record()
        torch.cuda.synchronize(dev)
        ms = ev[0].elapsed_time(ev[1]) / reps
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            call(which, t)
        ms = (time.perf_counter() - t0) * 1e3 / reps
    return {"ms": ms, "Mrows_s": N / ms / 1e3}


def profile_ms(fn) -> dict:
    """Device ms by kernel name of one call of fn (torch.profiler), after
    a warm-up call."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t and ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.key[:60]] = t / 1e3
    return out


def glue_us(which: str, t: dict, reps: int = 200) -> dict:
    """Host µs a call (mean of `reps` without a synchronize) of each piece
    of probe `which`'s glue: the check, the output's allocation (and the
    scratch's, for accum), the loaded library, the stream handle, the C
    entry alone; then the whole wrapper and, for copy and grid,
    index_select."""
    idx, tbl = t["idx"], t["tbl"]
    N = idx.shape[0]
    vecs = {"rot": [idx, t.get("rot")],
            "accum": [idx, t.get("dst")]}.get(which, [idx])
    fn = getattr(_cuda.lib(), "tbz_" + which + "_rows")
    out = tbl.new_empty(N, WORDS)
    st = _cuda.stream(out)
    args = (*(v.data_ptr() for v in vecs), N, tbl.data_ptr(), tbl.shape[0],
            out.data_ptr())
    pieces = {"check": lambda: _check(tbl, *vecs),
              "new_empty": lambda: tbl.new_empty(N, WORDS)}
    if which == "accum":
        ws = tbl.new_empty(accum_scratch_ints(N))
        args += (ws.data_ptr(), ws.numel())
        pieces["scratch"] = lambda: tbl.new_empty(accum_scratch_ints(N))
    pieces.update({
        "lib": _cuda.lib,
        "stream": lambda: _cuda.stream(out),
        "c_entry": lambda: fn(*args, st),
        "call": lambda: call(which, t)})
    if which in ("copy", "grid"):
        pieces["index_select"] = lambda: torch.index_select(tbl, 0, idx)
    res = {}
    for k, f in pieces.items():
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        res[k] = (time.perf_counter() - t0) * 1e6 / reps
        torch.cuda.synchronize()
    return res


def main(argv: list[str]) -> int:
    which = argv[0] if argv else "copy"
    N = int(argv[1]) if len(argv) > 1 else 8192
    R = int(argv[2]) if len(argv) > 2 else 4096
    r = probe(which, N, R, reps=10)
    print(f"{which}_rows N={N} R={R}: OK  {r['ms']:.4f}ms  "
          f"{r['Mrows_s']:.1f} M rows/s", flush=True)
    t = to_tensors(probe_inputs(which, N, R), "cuda")
    k = profile_ms(lambda: call(which, t))
    print(f"  kernel alone (profiler, ms): {k}", flush=True)
    g = glue_us(which, t)
    print("  glue a call (host us): " + ", ".join(
        f"{k} {v:.2f}" for k, v in g.items()), flush=True)
    if which in ("copy", "grid"):
        lib = lambda: torch.index_select(t["tbl"], 0, t["idx"])  # noqa: E731
        lib()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(10):
            lib()
        ev[1].record()
        torch.cuda.synchronize()
        print(f"  index_select: {ev[0].elapsed_time(ev[1]) / 10:.4f}ms, "
              f"alone {profile_ms(lib)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
