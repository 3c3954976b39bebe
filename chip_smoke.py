#!/usr/bin/env python3
"""Smoke run of tbz_torch on one NVIDIA GPU: build, check, decode.

    python3 chip_smoke.py [--out DIR]

(--out DIR also writes every measurement to DIR/chip_smoke.json.
Phase 9b starts its group's processes as
`chip_smoke.py --mesh-worker RANK WORLD PORT DEVICE_TYPE SHARD_BYTES`.)

Phases (any failure exits non-zero, and no result line is printed):
  1. the card's name and power limit; build the CUDA kernels (nvcc, one
     process per source, in parallel) and the native host library (g++)
     from this checkout's sources, and print the build seconds;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes of a 1 MiB zlib level-6 stream (its plan, its output for the
     CRC-32 and Adler-32 kernels, tail and front, from a prev other than
     the default, and both combines, also against stdlib zlib; a batch of
     three such members for the batched resolve; its tape's flat span
     plan for the flat resolver), and the sequential device tokenizer on
     63 KB bodies (levels 0, 1, 6, 9, Z_FIXED, 20 bit flips, and 200 KB
     of stored blocks across its staging chunks, a short tape, a bad
     code-length repeat); the stitch also on streams of short dynamic
     blocks (with EXT_BITS 384 and 8), a hand-built merge-point mask tape
     and 12 seeded synthetic lane tapes; the table build and the lane
     decode also on adversarial codes (11-15-bit codes in both alphabets,
     a single 1-bit code, over-subscribed, incomplete and padded sets)
     and lanes (a shuffled tbl_idx, starts at or past total_bits, an odd
     L, the speculative tier's B = 1, L = 1, 7, 256, S = 384), with the
     lane decode's shared-root misses printed; the resolve kernels also
     on tests/torch_util.py's adversarial tapes (resolve_core and
     splice_resolve: a 1 MiB distance-1 run 19 passes deep, chains at
     distance 32768 into a preset window, stored runs between matches;
     resolve_batch: rows of very different depths, an empty row and a
     row that fills the capacity; resolve_flat: deep-overlap plans at
     three G / K / seg_rows shapes and the adversarial tapes' plans);
     the checksum kernels also on ranges at offsets 1-15, rows whose
     stride(0) is not a multiple of 16 and lengths from 0 to the whole
     row: exact equality (tolerance 0, all outputs are integers or bytes,
     pass counts too), timed with CUDA events after a synchronize, the
     stitch per pass;
  3. the main path, tbz_torch.decompress(payload) with the defaults, on
     five streams (1 MiB raw level 9, 1 MiB zlib level 6, a two-member
     gzip, a stored/static/dynamic mix, 64 MiB gzip level 6): output
     byte-identical to stdlib zlib/gzip, every kernel of the path launched
     (counts reset just before, read just after), and the fused stage
     times (each after a synchronize); (b) the main path's kernels at the
     64 MiB stream's shapes, the stitch per pass, the resolve kernels held
     to their plain versions there, and the fused resolve stage taken
     apart: the splice plan's upload and the splice + resolve kernel, each
     by the host clock and by CUDA events;
  4. error classes: a truncated stream and a too-far distance raise the
     class zlib's error names;
  5. the device-resident path, decompress(device_resident=True) on the
     five streams: CUDA tensors equal to zlib's bytes (fetched after the
     timed calls), checksums verified on the card (its kernels launched),
     the 64 MiB e2e beside phase 3's, the CRC-32 and Adler-32 kernels
     alone on its body, fetch=False moving 4 output bytes, a flipped CRC
     and a
     truncation raising zlib's classes;
  6. CRC-32 and Adler-32, tail and front, of 640 MiB of seeded bytes on
     the card (more than 2^29) against zlib on the host;
  7. parallel.shard.decode_streams_sharded on twelve seeded streams at
     the sizes of the Silesia corpus's files (211 MB; nine gzip, two of
     them two-member, two zlib, one raw): byte-identical to zlib, a
     corrupt CRC reported at its position, device_resident rows, e2e
     median of 3, the stage split, the batched resolve against its plain
     version at every bucket (pass count and bytes, exact), and the
     kernels at the largest bucket;
  8. the route of the bodies the fused decode declines, through
     decompress with the default frontend and with frontend="device":
     (a) 32 seeded raw/zlib/gzip bodies of 1-63 KB at levels 0, 1, 6, 9
     and Z_FIXED, (b) the 64 MiB data as a static-only and a stored-only
     gzip stream, byte-identical to zlib, the route's kernels launched,
     e2e medians and the stage split; (c) the flat span resolver against
     pointer doubling on the static-only tape, in turns, each held to its
     plain version; (d) error
     classes through the device frontend; (e) the route's kernels at
     the shapes of a 63 KB and the 64 MiB static-only body (the
     sequential tokenizer's tape resolved and held against zlib);
  9. the several-card path: (a) make_sharded_crc32 / make_sharded_adler32
     of phase 6's 640 MiB buffer over a mesh of 4 entries (the card's own
     devices where there are 4, else cuda:0 named four times), n = all
     of it, 777 bytes less, 5000 and 0, against zlib, with the per-shard
     kernel and combine-tree times; (b) a torch.distributed NCCL group
     of one process per local card (world size 1 on one card: the NCCL
     all_gather still runs on it): each process runs the sharded
     checksums over the global mesh and the mesh-wide resolve batch of
     a small multi-stream set, checking its own rows, under a timeout;
     (c) phase 7's batch through decode_streams_sharded(payloads, mesh)
     over every local card and over cuda:0 named twice: byte-identical
     to zlib and to phase 7's output, e2e median of 3;
  10. the row-gather probes (tbz_torch.ops.rowgather, the port of
     scripts/pallas_spike_r3.py's four Pallas kernels) through their
     entry point at the spike's shapes (N=8192, R=4096) and at N=2^22,
     R=2^20, then each kernel against its plain version (exact), its time
     beside the plain version's and the library call's (index_select;
     index_select + index_add_ for accum; none for rot), its bound (each
     distinct gathered table row read once) and gather_bound_ms (every
     gathered row read); copy_rows and grid_rows also on edge cases at
     both shapes (ragged N, indices outside the table, idx and table
     views 4 bytes into their storage), and all four kernels on rot_rows'
     and accum_rows' edge cases (rot over all of int32, dst outside the
     output, all rows into row 0, a skew, accum_rows' bucket tiers),
     exact;
     (b) the flat span resolve through tbz's two baseline layouts
     (_resolve_flat_scan_impl, _resolve_flat_gscat_impl) on phase 2's
     1 MiB plan: equal to _resolve_flat_impl, its plain version and zlib,
     timed in turns;
  11. the rest of the public calls, each output byte-identical to stdlib
     zlib / gzip / zipfile and each timed after a synchronize: (a)
     compress of phase 3's 64 MiB data at levels 1 and 6 (threads=4, the
     thread executor) and of its first 8 MiB at level 9, each no larger
     than zlib.compress at the same level, decoded by decompress on the
     card (the fused kernels launched); (b) decompress_file of phase 3's
     64 MiB gzip from a temporary file, fetched and device_resident=True
     (CRC-32 on the card), beside phase 3's decompress of the same bytes;
     (c) decompress_into of the 1 MiB zlib stream and the two-member
     gzip; (d) decompress_stream of the 64 MiB gzip in 1 MiB chunks, and a
     Decompressor fed the 1 MiB zlib stream in chunks of 1, 7 and 65,536
     bytes, restored from a checkpoint half way; (e) ZipWriter of phase
     7's twelve Silesia-sized members at level 6 (read back by zipfile),
     ZipReader.read of each on the card (the fused kernels launched for
     each member of 64 KB and more), read_all on the card and with
     backend="host" (no kernel launched);
  then the run's wall time, a `kernels` JSON line (launch counts summed
  over the paths of phases 3, 5, 7, 8, 9a, 9c, 10 and 11, the phase-2
  times, and the phase-10 times at N=2^22), the nvidia-smi line, and the
  final result line.

Data comes from a seeded numpy generator of a Silesia-like mix (text,
structured binary records, random bytes, runs). Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys
import threading
import time
import zlib

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
SEED = 20261016
MIB = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def corpus(seed: int, size: int) -> bytes:
    """Silesia-like mix, generated in bulk: text lines, structured binary
    records, random bytes and byte runs, in random order."""
    rng = np.random.default_rng(seed)
    words = np.array([b"the", b"of", b"stream", b"block", b"kernel",
                      b"window", b"tensor", b"huffman", b"deflate",
                      b"record", b"offset", b"value", b"index", b"table"])
    out, total = [], 0
    while total < size:
        kinds = rng.integers(0, 4, 4096)
        for k in kinds:
            if k == 0:
                n = int(rng.integers(4, 40))
                p = b" ".join(words[rng.integers(0, len(words), n)]) + b"\n"
            elif k == 1:
                n = int(rng.integers(2, 24))
                rec = np.zeros((n, 4), np.int32)
                rec[:, 0] = np.arange(n) + int(rng.integers(1 << 24))
                rec[:, 1] = rng.integers(0, 1000, n)
                rec[:, 2] = 0x00C0FFEE
                rec[:, 3] = rng.integers(0, 4, n)
                p = rec.tobytes()
            elif k == 2:
                p = rng.integers(0, 256, int(rng.integers(8, 160)),
                                 dtype=np.uint8).tobytes()
            else:
                p = bytes([int(rng.integers(256))]) * int(rng.integers(3, 300))
            out.append(p)
            total += len(p)
            if total >= size:
                break
    return b"".join(out)[:size]


def raw_deflate(data: bytes, level: int, zdict: bytes | None = None) -> bytes:
    args = (level, zlib.DEFLATED, -15)
    if zdict is not None:
        args += (9, zlib.Z_DEFAULT_STRATEGY, zdict)
    co = zlib.compressobj(*args)
    return co.compress(data) + co.flush()


def fixed_deflate(data: bytes, wbits: int = -15) -> bytes:
    """Static Huffman blocks only (Z_FIXED), level 6."""
    co = zlib.compressobj(6, zlib.DEFLATED, wbits, 9, zlib.Z_FIXED)
    return co.compress(data) + co.flush()


def fit_body(seed: int, target: int, pack) -> tuple:
    """(pack(data), data) for seeded data sized so that the packed
    stream lies just under `target` bytes."""
    n, best = target, None
    for _ in range(12):
        data = corpus(seed, n)
        body = pack(data)
        if len(body) <= target and (best is None
                                    or len(body) > len(best[0])):
            best = body, data
        if 0.9 * target <= len(body) <= target:
            break
        n = max(64, int(n * 0.97 * target / len(body)))
    expect(best is not None, f"no body under {target} B")
    return best


def single_bit_cl_header() -> bytes:
    """A dynamic block header whose code-length code is one 1-bit code
    (zlib: "invalid code lengths set")."""
    bits = [1, 0, 1] + [0] * 14                      # BFINAL, BTYPE 2, HLIT,
    for v in (1, 0, 0, 0):                           # HDIST, HCLEN = 4
        bits += [(v >> k) & 1 for k in range(3)]
    bits += [0] * 8
    out = bytearray((len(bits) + 7) // 8)
    for i, bit in enumerate(bits):
        out[i // 8] |= bit << (i % 8)
    return bytes(out)


def mixed_stream(seed: int) -> bytes:
    """Dynamic, stored and static blocks in one raw stream."""
    rng = np.random.default_rng(seed)
    co = zlib.compressobj(9, zlib.DEFLATED, -15)
    p1 = co.compress(corpus(seed, 600 << 10)) + co.flush(zlib.Z_FULL_FLUSH)
    st = zlib.compressobj(0, zlib.DEFLATED, -15)
    p2 = st.compress(rng.integers(0, 256, 200 << 10,
                                  dtype=np.uint8).tobytes())
    p2 += st.flush(zlib.Z_FULL_FLUSH)
    fx = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    p3 = fx.compress(corpus(seed + 1, 200 << 10)) + fx.flush()
    return p1 + p2 + p3


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


class Failed(Exception):
    pass


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def timed(fn, dev, reps: int, warm: bool = True) -> float:
    """Mean ms per call: CUDA events around `reps` calls after a
    synchronize, and after one warm-up call unless `warm` is false (host
    clock on the CPU)."""
    import torch
    if warm:
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def build(dev) -> dict:
    """Phase 1: build the kernels and the native library in parallel."""
    from tbz_torch import _cuda
    from tbz_torch.native import loader as NL
    t0 = time.perf_counter()
    native = {}
    th = threading.Thread(target=lambda: native.update(ok=NL.available(),
                                                       s=time.perf_counter()
                                                       - t0))
    th.start()
    if dev.type == "cuda":
        _cuda.lib()
    th.join()
    expect(native.get("ok", False), "native host library did not build")
    return {"kernels_s": _cuda.build_seconds, "native_s": native["s"],
            "total_s": time.perf_counter() - t0}


def table_entries(data32, lt, dt, tbl_idx, starts, packed, Ln: int) -> int:
    """Distinct flat-table entries that the real lanes' emitted symbols
    look up: the litlen entry of every symbol, the distance entry of
    every match (the lookups of tbz_torch/ops/batched.py's lane decode)."""
    import torch
    from tbz_torch.ops import tokenize_device as TD
    st = starts[:, :Ln].long()
    emit = st >= 0
    p = st[emit]
    tb = (tbl_idx[:Ln].long().expand_as(st) << TD.TBITS)[emit]
    words = data32.long() & 0xFFFFFFFF

    def peek(q, n):
        w = words[q >> 5] | (words[(q >> 5) + 1] << 32)
        return (w >> (q & 31)) & ((1 << n) - 1)

    li = tb | peek(p, TD.TBITS)
    e = lt.reshape(-1).long()[li]
    m = (packed[:, :Ln].long()[emit] & 0x1FF) >= 3   # match lengths
    di = tb[m] | peek(p[m] + TD._e_nbits(e[m]) + TD._e_extra(e[m]),
                      TD.TBITS)
    return int(torch.unique(li).numel() + torch.unique(di).numel())


def test_util():
    """tests/torch_util.py of this checkout (its seeded stream and
    lane-tape builders)."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if d not in sys.path:
        sys.path.insert(0, d)
    import torch_util
    return torch_util


def lane_tape(dev, body: bytes) -> list:
    """Kernels 1-2 on `body`'s plan: kernel 3's arguments (the lane tape,
    the plan's arrays, L, S, B and a flat buffer holding kernel 1's err
    words and kernel 2's exits)."""
    import torch
    from tbz_torch.native import loader as NL
    from tbz_torch.ops import batched as B
    from tbz_torch.ops import tokenize_device as TD
    plan = B._build_plan(len(body) * 8, NL.scan_headers(body), 8192)
    dp = B.plan_from_numpy(plan, dev)
    L, Bp = plan.L, plan.B
    flat = torch.zeros(plan.hdr_len + plan.n_out + 1, dtype=torch.int32,
                       device=dev)
    lt, dt, _, _ = TD.build_flat_table(dp.lit_pad, dp.dist_pad,
                                       flat[7 * L:7 * L + Bp],
                                       flat[7 * L + Bp:7 * L + 2 * Bp])
    starts, packed, dist, _, ok = B._lanes_multi(
        B.stage_stream(body, dev), lt, dt, dp.tbl_idx, dp.lane_starts,
        dp.lane_ends, len(body) * 8, plan.S, exits=flat[4 * L:5 * L])
    return [starts, packed, dist, ok, dp.tbl_idx, dp.seg_id, dp.seg_sym,
            L, plan.S, Bp, flat]


def stitch_vs_plain(args) -> tuple:
    """Kernel 3 and its plain version on one input: (max abs difference
    over the header and compact[:total], flags)."""
    from tbz_torch.ops import batched as B
    L, Bp = args[7], args[9]
    k = B._stitch_compact(*args[:10], args[10].clone())
    p = B._stitch_compact_plain(*args[:10], args[10].clone())
    hdr = 7 * L + 2 * Bp + 1
    total = int(p[hdr - 1])
    return (max(max_abs_err(k[:hdr], p[:hdr]),
                max_abs_err(k[hdr:hdr + total], p[hdr:hdr + total])),
            p[2 * L:3 * L].cpu())


def stitch_adversarial(dev) -> int:
    """Kernel 3 against its plain version on streams of many short
    dynamic blocks (flushes every 200-3000 bytes), the same with forced
    junctions (EXT_BITS = 8), the hand-built merge-point mask tape and 12
    seeded synthetic tapes. Returns the max abs difference."""
    import torch
    from tbz_torch.ops import batched as B
    tu = test_util()
    errs, flags = [], []
    saved = B.EXT_BITS
    try:
        for ext in (saved, 8):
            B.EXT_BITS = ext
            for seed in (1, 2):
                e, f = stitch_vs_plain(lane_tape(
                    dev, tu.short_blocks(SEED + seed, 200 << 10)))
                errs.append(e)
                flags.append(f)
    finally:
        B.EXT_BITS = saved
    mask = tu.stitch_flat(tu.stitch_mask_tape(), dev)
    e, f = stitch_vs_plain(mask)
    errs.append(e)
    k = B._stitch_compact(*mask[:10], mask[10].clone())
    expect(k[:3].tolist() == [0, 2, 2], "stitch: the mask case's merge "
           f"positions are {k[:3].tolist()}, not [0, 2, 2]")
    for seed in range(12):
        errs.append(stitch_vs_plain(tu.stitch_flat(
            tu.stitch_random_tape(SEED + seed), dev, seed))[0])
    fl = torch.cat(flags)
    log(f"  stitch_compact: short-block streams (x2 EXT_BITS), the mask "
        f"tape and 12 synthetic tapes: max_abs_err {max(errs)}; flags "
        f"skip {int(((fl & B.F_SKIP) != 0).sum())}, dead "
        f"{int(((fl & B.F_DEAD) != 0).sum())}, eob "
        f"{int(((fl & B.F_EOB) != 0).sum())}")
    return max(errs)


def tables_adversarial(dev) -> int:
    """Kernel 1 against its plain version on tests/torch_util.py's
    adversarial code lengths (two seeds): codes of 11-15 bits in both
    alphabets, a single 1-bit code, over-subscribed and incomplete sets,
    an all-zero padded row, the fixed code. err must be equal everywhere,
    the tables where err == 0 and where the code is incomplete (row 4;
    an over-subscribed table's content is the kernel's own). Returns the
    max abs difference."""
    import torch
    from tbz_torch.ops import tokenize_device as TD
    tu = test_util()
    lit_c, dist_c = TD._consts_on(dev)
    errs, n_err = [], 0
    for seed in (SEED + 1, SEED + 2):
        lit, dist = (torch.from_numpy(a).to(dev)
                     for a in tu.adversarial_tables(seed))
        lt, dt, le, de = TD.build_flat_table(lit, dist)
        for k, e, c, lens in ((lt, le, lit_c, lit), (dt, de, dist_c, dist)):
            p, pe = TD._build_flat_table_plain(lens, c, True)
            expect(torch.equal(e, pe), "table err (adversarial codes)")
            same = (e == 0) | (torch.arange(len(e), device=dev) == 4)
            errs.append(max_abs_err(k[same], p[same]))
            n_err += int((e != 0).sum())
    log(f"  build_flat_table: adversarial codes (2 seeds x 8 rows x 2 "
        f"alphabets, {n_err} with err): max_abs_err {max(errs)}")
    return max(errs)


def lanes_adversarial(dev) -> int:
    """Kernel 2 against its plain version on kernel 1's tables of
    tests/torch_util.py's LANE_CASES: codes of 11-15 bits (root misses),
    err and padded tables, a shuffled tbl_idx, lanes at or past
    total_bits, L not a multiple of 32, and the speculative shape (B = 1,
    L = 1, 7, 256, S = 384). Prints the root misses; returns the max abs
    difference."""
    from tbz_torch.ops import batched as B
    from tbz_torch.ops import tokenize_device as TD
    tu = test_util()
    errs, lookups, misses = [], 0, 0
    for case in tu.LANE_CASES:
        (lit, dist), (d32, tbl, st, en, tb, S) = tu.lane_case(case, dev)
        lt, dt, _, _ = TD.build_flat_table(lit, dist)
        a = (d32, lt, dt, tbl, st, en, tb, S)
        k = B._lanes_multi(*a)
        errs.append(max(max_abs_err(x, y)
                        for x, y in zip(k, B._lanes_multi_plain(*a))))
        n, m = tu.root_misses(d32, lt, dt, tbl, k[0], k[1])
        lookups, misses = lookups + n, misses + m
    log(f"  lanes_multi: {len(tu.LANE_CASES)} adversarial cases (L = "
        f"{', '.join(str(c[1]) for c in tu.LANE_CASES)}): max_abs_err "
        f"{max(errs)}; root misses {misses} of {lookups} lookups")
    return max(errs)


def resolve_adversarial(dev, kernel: str) -> int:
    """resolve_core, or splice_resolve with every token a host token,
    against its plain version (on the CPU) on tests/torch_util.py's three
    1 MiB adversarial tapes (resolve_case: a distance-1 run ~20 doubling
    passes deep, chains at distance 32768 into a preset window, stored
    runs between matches): whole buffers and pass counts equal, and the
    tape's bytes. Returns the max abs difference."""
    import torch
    from tbz_torch.ops import fused as F
    from tbz_torch.ops import resolve as R
    tu = test_util()
    errs, passes = [], []
    for i, kind in enumerate(tu.RESOLVE_KINDS):
        tape, inp, win, want = tu.resolve_case(kind, SEED + 40 + i)
        n = tape.total_out
        if kernel == "resolve_core":
            k, _, kp = R.resolve_device(tape, inp, win, device=dev,
                                        collect_stats=True)
            p, _, pp = R.resolve_device(tape, inp, win, device="cpu",
                                        collect_stats=True)
            lo = R.W
        else:
            pb = tu.host_splice(tape, win)
            u8 = torch.from_numpy(np.frombuffer(inp or b"\0",
                                                np.uint8).copy())
            compact = torch.zeros(1, dtype=torch.int32)
            k, kp = F._splice_resolve(compact.to(dev), u8.to(dev),
                                      F.splice_inputs_from_numpy(pb, win,
                                                                 dev))
            p, pp = F._splice_resolve_plain(
                compact, u8, F.splice_inputs_from_numpy(pb, win, "cpu"))
            lo = 4 + R.W
        expect(int(kp) == pp, f"{kernel} on the {kind} tape: {int(kp)} "
               f"doubling passes, the plain version {pp}")
        expect(k[lo:lo + n].cpu().numpy().tobytes() == want,
               f"{kernel} on the {kind} tape differs from its bytes")
        errs.append(max_abs_err(k.cpu(), p))
        passes.append(pp)
    log(f"  {kernel}: adversarial tapes {list(tu.RESOLVE_KINDS)} "
        f"({passes} passes): max_abs_err {max(errs)}")
    return max(errs)


def batch_adversarial(dev) -> int:
    """Kernel 7 against its plain version (on the CPU) on
    tests/torch_util.py's resolve_batch_case: a deep run, an empty row, a
    far-chain row with a preset window that fills the capacity exactly,
    a stored row, 100 literals. Returns the max abs difference."""
    import torch
    from tbz_torch.ops import resolve as R
    tu = test_util()
    rows, cap = tu.resolve_batch_case(SEED + 45)
    ol, di, rv, nt, tot, inp, win, cap = tu.stage_resolve_batch(rows, cap)

    def run(d):
        up = [torch.from_numpy(a).to(d) for a in (ol, di, rv, nt)]
        return R._resolve_batch(*up, tot, torch.from_numpy(inp).to(d),
                                torch.from_numpy(win).to(d), cap)

    k, kp = run(dev)
    p, pp = run(torch.device("cpu"))
    expect(int(kp) == pp, f"resolve_batch on the adversarial rows: "
           f"{int(kp)} doubling passes, the plain version {pp}")
    for r, (_, _, _, want) in enumerate(rows):
        expect(k[r, :len(want)].cpu().numpy().tobytes() == want,
               f"resolve_batch: adversarial row {r} differs")
    err = max_abs_err(k.cpu(), p)
    log(f"  resolve_batch: adversarial rows {[len(r[3]) for r in rows]} B "
        f"(cap {cap}, {pp} passes): max_abs_err {err}")
    return err


def flat_adversarial(dev) -> int:
    """The flat span resolve against its plain version (on the CPU) on
    tests/torch_util.py's flat_plan_cases: the deep-overlap data at three
    G / K / seg_rows shapes and the plans of the three adversarial tapes.
    Returns the max abs difference."""
    from tbz_torch.native import loader as NL
    from tbz_torch.ops import resolve_spans as RS
    errs = []
    for name, tape, inp, win, want, G, K, sr in test_util().flat_plan_cases():
        plan = NL.plan_spans_flat(tape, inp, window_len=len(win), G=G, K=K,
                                  seg_rows=sr)
        st = RS.stage_flat_plan(plan, win)
        k = RS._resolve_flat_impl(RS.flat_plan_from_numpy(st, dev))
        p = RS._resolve_flat_plain(RS.flat_plan_from_numpy(st, "cpu"))
        expect(k[:plan.total_out].cpu().numpy().tobytes() == want,
               f"resolve_flat on {name} differs from its bytes")
        errs.append(max_abs_err(k.cpu(), p))
    log(f"  resolve_flat: {len(errs)} more plans (deep overlaps at 3 "
        f"shapes, 3 adversarial tapes): max_abs_err {max(errs)}")
    return max(errs)


def stored_bytes(ol, rv) -> int:
    """Bytes that stored-block tokens copy from the input."""
    from tbz_torch.tape import STORED_FLAG
    ol, rv = np.asarray(ol, np.int64), np.asarray(rv, np.int64)
    return int(ol[(rv & STORED_FLAG) != 0].sum())


def kernel_cases(dev, body: bytes, data: bytes,
                 adversarial: bool = True) -> list:
    """Every kernel of the main path at the shapes of `body`'s plan:
    its kernel call, its plain version, an exact comparison of the two
    (returns the max abs difference; with `adversarial`, also over each
    kernel's adversarial inputs) and the bytes it must move for this
    data: each input the function needs read once, each output written
    once. Only the real lanes and candidate tables count (the plan pads
    both to powers of two), and only the parts of the lane tape that the
    stitch and the compaction need."""
    import torch
    from tbz_torch.native import loader as NL
    from tbz_torch.ops import batched as B
    from tbz_torch.ops import fused as F
    from tbz_torch.ops import resolve as R
    from tbz_torch.ops import tokenize_device as TD

    nbits = len(body) * 8
    scan = NL.scan_headers(body)
    plan = B._build_plan(nbits, scan, 8192)
    dp = B.plan_from_numpy(plan, dev)
    data32 = B.stage_stream(body, dev)
    L, S, Bp, hdr = plan.L, plan.S, plan.B, plan.hdr_len
    Ln, Bn = plan.Ln, plan.Bn
    log(f"plan: {len(body)} B body, L={L} S={S} B={Bp} "
        f"candidates={Bn} lanes={Ln}")

    def max_err(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    cases = []

    def case(name, source, replaces, run, plain, compare, nbytes):
        cases.append(dict(name=name, source=source, replaces=replaces,
                          run=run, plain=plain, compare=compare,
                          nbytes=nbytes))

    # kernel 1: flat tables
    lit_c, dist_c = TD._consts_on(dev)
    lt, dt, le, de = TD.build_flat_table(dp.lit_pad, dp.dist_pad)

    def plain1():
        return (TD._build_flat_table_plain(dp.lit_pad, lit_c, True),
                TD._build_flat_table_plain(dp.dist_pad, dist_c, True))

    def compare1():
        (plt, ple), (pdt, pde) = plain1()
        expect(torch.equal(le, ple) and torch.equal(de, pde), "table err")
        return max(max_err(lt[le == 0], plt[le == 0]),
                   max_err(dt[de == 0], pdt[de == 0]),
                   tables_adversarial(dev))

    case("build_flat_table", "tbz_torch/csrc/tables.cu",
         "tbz/ops/tokenize_device.py:91",
         lambda: TD.build_flat_table(dp.lit_pad, dp.dist_pad), plain1,
         compare1, 4 * (Bn * 320 + 320) + 4 * (2 * Bn * TD.TSIZE + 2 * Bn))

    # kernel 2: lane decode
    args = (data32, lt, dt, dp.tbl_idx, dp.lane_starts, dp.lane_ends,
            nbits, S)
    ks = B._lanes_multi(*args)
    starts, packed, dist, exits, ok = ks

    def compare2():
        n, m = test_util().root_misses(data32, lt, dt, dp.tbl_idx[:Ln],
                                       starts[:, :Ln], packed[:, :Ln])
        log(f"  lanes_multi at the plan: root misses {m} of {n} lookups "
            f"({100 * m / max(n, 1):.2f}%)")
        return max(max(max_err(a, b) for a, b in
                       zip(ks, B._lanes_multi_plain(*args))),
                   lanes_adversarial(dev))

    case("lanes_multi", "tbz_torch/csrc/lanes.cu", "tbz/ops/batched.py:82",
         lambda: B._lanes_multi(*args),
         lambda: B._lanes_multi_plain(*args), compare2,
         len(body) + 4 * table_entries(data32, lt, dt, dp.tbl_idx, starts,
                                       packed, Ln)
         + 4 * 3 * Ln + 4 * (3 * Ln * S + 2 * Ln))

    # kernel 3: stitch + compaction, on the kernel's lane outputs
    def fresh_flat():
        f = torch.zeros(hdr + plan.n_out + 1, dtype=torch.int32, device=dev)
        f[4 * L:5 * L] = exits
        f[7 * L:7 * L + Bp] = le
        f[7 * L + Bp:7 * L + 2 * Bp] = de
        return f

    sargs = (starts, packed, dist, ok, dp.tbl_idx, dp.seg_id, dp.seg_sym,
             L, S, Bp)
    kf = B._stitch_compact(*sargs, fresh_flat())
    total = int(kf[hdr - 1])
    # the stitch reads each real lane's emitted starts (and the slot that
    # ends them), its last packed word and 4 per-lane inputs, and the 2
    # err words of each candidate; the compaction reads packed and dist
    # over each lane's spliced range, `total` slots in all
    n_emitted = int((starts[:, :Ln] >= 0).sum())

    def compare3():
        pf = B._stitch_compact_plain(*sargs, fresh_flat())
        return max(max_err(kf[:hdr], pf[:hdr]),
                   max_err(kf[hdr:hdr + total], pf[hdr:hdr + total]),
                   stitch_adversarial(dev))

    kflat = fresh_flat()
    case("stitch_compact", "tbz_torch/csrc/stitch.cu",
         "tbz/ops/batched.py:191",
         lambda: B._stitch_compact(*sargs, kflat),
         lambda: B._stitch_compact_plain(*sargs, fresh_flat()), compare3,
         4 * (n_emitted + 6 * Ln + 2 * Bn + 2 * total) + 4 * (hdr + total))
    if dev.type == "cuda":
        cases[-1]["passes"] = lambda: B.stitch_pass_ms(*sargs, fresh_flat())

    # kernel 4: splice + distance check + resolve, from the real walk
    meta = B._parse_meta(kf[:hdr].cpu().numpy(), plan)
    pb = F._PlanBuilder(meta)
    B._walk(body, scan, plan, meta, B._new_stats(), pb.emit_dev,
            pb.emit_host)
    si = F.splice_inputs_from_numpy(pb, b"", dev)
    compact = kf[hdr:hdr + plan.n_out + 1]
    u8 = data32.view(torch.uint8)
    n4 = 4 + R.W + pb.n_bytes

    def compare4():
        kout, kpass = F._splice_resolve(compact, u8, si)
        pout, ppass = F._splice_resolve_plain(compact, u8, si)
        expect(int(kpass) == ppass, "doubling pass counts differ")
        expect(kout[4 + R.W:n4].cpu().numpy().tobytes() == data,
               "splice+resolve output differs from zlib")
        log(f"  splice_resolve: {int(kpass)} doubling passes, "
            f"{si.n_total} tokens, {pb.n_host} host tokens")
        return max(max_err(kout[:n4], pout[:n4]),
                   resolve_adversarial(dev, "splice_resolve")
                   if adversarial else 0)

    h_ol = np.concatenate(pb.h_ol) if pb.n_host else np.empty(0, np.int32)
    h_rv = np.concatenate(pb.h_rv) if pb.n_host else np.empty(0, np.int32)
    case("splice_resolve", "tbz_torch/csrc/splice.cu", "tbz/ops/fused.py:54",
         lambda: F._splice_resolve(compact, u8, si),
         lambda: F._splice_resolve_plain(compact, u8, si), compare4,
         4 * (si.n_total - pb.n_host) + 4 * 3 * (len(pb.dst) + pb.n_host)
         + stored_bytes(h_ol, h_rv) + si.window_len + n4)
    # the splice plan's upload (the host part of decode_stream_fused's
    # resolve stage) and the kernel, to time apart
    cases[-1]["upload"] = lambda: F.splice_inputs_from_numpy(pb, b"", dev)
    cases[-1]["kernel"] = lambda s: F._splice_resolve(compact, u8, s)

    # kernel 4's core alone: the route of streams the fused path
    # declines (host tokenizer -> device resolve), at the same sizes
    tape = NL.tokenize(body).tape
    T = R._pad_pow2(len(tape))
    cap = R._pad_pow2(tape.total_out, floor=4096)

    def up(a):
        z = np.zeros(T, np.int32)
        z[:len(a)] = a
        return torch.from_numpy(z).to(dev)

    inp = torch.from_numpy(np.frombuffer(body, np.uint8).copy()).to(dev)
    rargs = (up(tape.out_len), up(tape.dist), up(tape.root_val), len(tape),
             inp, R.window_tensor(b"", dev), cap)
    n5 = R.W + tape.total_out

    def compare5():
        kr, kp = R._resolve_core(*rargs)
        pr, pp = R._resolve_core_plain(*rargs)
        expect(int(kp) == pp, "doubling pass counts differ")
        log(f"  resolve_core: {int(kp)} doubling passes, {len(tape)} "
            "tokens")
        return max(max_err(kr[:n5], pr[:n5]),
                   resolve_adversarial(dev, "resolve_core")
                   if adversarial else 0)

    case("resolve_core", "tbz_torch/csrc/resolve.cu",
         "tbz/ops/resolve.py:37", lambda: R._resolve_core(*rargs),
         lambda: R._resolve_core_plain(*rargs), compare5,
         4 * 3 * len(tape) + stored_bytes(tape.out_len, tape.root_val) + n5)
    return cases


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def bad_cl_repeat_header() -> bytes:
    """A dynamic block header whose first code-length symbol is a repeat
    (16) with nothing to repeat (zlib: "invalid bit length repeat")."""
    bits = [1, 0, 1] + [0] * 14                  # BFINAL, BTYPE 2, HLIT,
    for v in (1, 0, 0, 1):                       # HDIST, HCLEN = 4: the
        bits += [(v >> k) & 1 for k in range(3)]  # codes of 16 and 0
    bits += [1] + [0] * 16                       # symbol 16 first
    out = bytearray((len(bits) + 7) // 8)
    for i, bit in enumerate(bits):
        out[i // 8] |= bit << (i % 8)
    return bytes(out)


def tokenize_case(dev, size: int) -> dict:
    """The sequential device tokenizer on bodies of at most `size` bytes
    (raw levels 0, 1, 6, 9 and a Z_FIXED one), 20 seeded bit flips of
    the level-6 body, and three edge cases: 200 KB of stored blocks (past
    one staging chunk, blocks across chunk boundaries), a tape shorter
    than the level-6 body's tokens, a bad code-length repeat. All eight
    outputs of the kernel and its plain version equal (the flips: the
    same error codes)."""
    import torch
    from tbz_torch.ops import tokenize_device as TD
    bodies = [(f"L{lv}",) + fit_body(SEED + 30 + i, size,
                                     lambda d, lv=lv: raw_deflate(d, lv))
              for i, lv in enumerate((0, 1, 6, 9))]
    bodies.append(("fixed",) + fit_body(SEED + 34, size, fixed_deflate))
    rng = np.random.default_rng(SEED + 35)
    flips = []
    for i in range(20):
        b = bytearray(bodies[2][1])
        b[int(rng.integers(len(b)))] ^= 1 << int(rng.integers(8))
        flips.append((f"flip{i}", bytes(b), None))

    def args(body):
        return (TD.stage_words(body, dev), len(body) * 8, 0,
                1 << max(10, len(body).bit_length()))

    main = args(bodies[2][1])
    n_tok = int(TD.tokenize_device_impl(*main)[1][0])

    def compare():
        errs, codes = [], set()
        for name, body, data in bodies + flips:
            a = args(body)
            kt, kr = TD.tokenize_device_impl(*a)
            pt, pr = TD._tokenize_device_plain(*a)
            expect(torch.equal(kr, pr), f"tokenize_device {name}: n_tok, "
                   "produced, end_bit, err or finished differ")
            errs.append(max_abs_err(kt, pt))
            if data is None:
                codes.add(int(kr[3]))
            else:
                expect(int(kr[3]) == 0 and int(kr[4]) == 1
                       and int(kr[1]) == len(data),
                       f"tokenize_device {name}: {kr.tolist()}")
        log(f"  tokenize_device: bodies of {[len(b) for _, b, _ in bodies]}"
            f" B and 20 bit flips (err codes {sorted(codes)}) equal")
        edges = (("stored_200KB", raw_deflate(corpus(SEED + 36, 200 << 10),
                                              0), None, 0),
                 ("overflow", bodies[2][1], n_tok // 2, 11),
                 ("bad_cl_repeat", bad_cl_repeat_header(), None, 7))
        for name, body, T, want in edges:
            a = args(body)
            a = a[:3] + (T or a[3],)
            kt, kr = TD.tokenize_device_impl(*a)
            pt, pr = TD._tokenize_device_plain(*a)
            expect(torch.equal(kr, pr) and int(kr[3]) == want,
                   f"tokenize_device {name}: {kr.tolist()} against the "
                   f"plain {pr.tolist()}")
            errs.append(max_abs_err(kt, pt))
        log(f"  tokenize_device: edge cases {[e[0] for e in edges]} equal")
        return max(errs)

    return dict(name="tokenize_device", source="tbz_torch/csrc/inflate.cu",
                replaces="tbz/ops/tokenize_device.py:191",
                run=lambda: TD.tokenize_device_impl(*main),
                plain=lambda: TD._tokenize_device_plain(*main),
                compare=compare, tokens=n_tok,
                nbytes=len(bodies[2][1]) + 12 * n_tok + 20)


def flat_plan_bytes(plan, window_len: int) -> int:
    """Bytes the flat resolve must move: the live slots (6 B each) and
    their groups' rows (4 B), the prefilled output and the window read
    once, the output written once."""
    live = (plan.lenoff.astype(np.int32) & 255) > 0
    groups = int(live.reshape(-1, plan.K).any(1).sum())
    return 6 * int(live.sum()) + 4 * groups + 2 * plan.total_out + window_len


def flat_case(dev, body: bytes, data: bytes) -> dict:
    """The flat span resolver on the plan of `body`'s tape (native
    tokenizer and planner, tbz's defaults G = 4096, K = 4)."""
    from tbz_torch.native import loader as NL
    from tbz_torch.ops import resolve_spans as RS
    plan = NL.plan_spans_flat(NL.tokenize(body).tape, body)
    fa = RS.flat_plan_from_numpy(RS.stage_flat_plan(plan), dev)
    n = plan.total_out

    def compare():
        k = RS._resolve_flat_impl(fa)
        p = RS._resolve_flat_plain(fa)
        expect(k[:n].cpu().numpy().tobytes() == data,
               "resolve_flat output differs from zlib")
        log(f"  resolve_flat: {plan.n_spans} spans in {plan.n_batches} "
            f"batches, {len(fa.seg_base)} segments")
        return max(max_abs_err(k, p), flat_adversarial(dev))

    return dict(name="resolve_flat", source="tbz_torch/csrc/spans.cu",
                replaces="tbz/ops/resolve_spans.py:145",
                run=lambda: RS._resolve_flat_impl(fa),
                plain=lambda: RS._resolve_flat_plain(fa), compare=compare,
                nbytes=flat_plan_bytes(plan, 0))


# prev values other than the defaults (0 for CRC-32, 1 for Adler-32);
# the Adler one is a valid (b << 16) | a with a, b < 65521
CRC_PREV = 0x5EED1234
ADLER_PREV = 0x1234ABCD


def checksum_edges(dev, name: str) -> int:
    """Kernel `name` on tests/torch_util.py's checksum_edge_cases (ranges
    at offsets 1-15, a stride(0) that is not a multiple of 16, lengths
    from 0 to the whole row), each row against its plain version and
    zlib. Returns the largest |kernel - plain|."""
    from tbz_torch import checksums as cs
    err = 0
    for nm, rows, offs, lens, prevs in test_util().checksum_edge_cases(dev):
        if nm != name:
            continue
        k = cs._rows(name, rows, offs, lens, prevs).cpu()
        p = cs._rows(name, rows.cpu(), offs, lens, prevs)
        host = rows.cpu().numpy()
        for i, (o, n, pv) in enumerate(zip(offs, lens, prevs)):
            expect(int(k[i]) == getattr(zlib, name)(
                host[i, o:o + n].tobytes(), int(pv)),
                f"{name}: edge row {i} (offset {o}, {n} B, stride "
                f"{rows.stride(0)}) differs from zlib")
        err = max(err, int((k - p).abs().max()))
    log(f"  {name}: edge rows (offsets 1-15, a stride that is not a "
        "multiple of 16, lengths 0 .. the whole row) equal zlib and the "
        "plain version")
    return err


def checksum_cases(dev, data: bytes) -> list:
    """Kernels 5 and 6 at the shapes of `data` (the 1 MiB output): the
    tail variant (bytes at the front of a buffer with slack after them)
    and the front variant (bytes at its end), each from a prev other than
    the default, both combines, and checksum_edges' rows; each against
    its plain version and stdlib zlib."""
    import torch
    from tbz_torch import checksums as cs
    n = len(data)
    host = np.zeros(n + 4096, np.uint8)
    host[:n] = np.frombuffer(data, np.uint8)
    tail_rows = torch.from_numpy(host).to(dev).unsqueeze(0)
    front_rows = torch.from_numpy(np.roll(host, 4096)).to(dev).unsqueeze(0)
    a, b = data[:n // 3], data[n // 3:]
    cases = []
    for name, prev, zfn, plain_fn in (
            ("crc32", CRC_PREV, zlib.crc32, cs._crc32_rows_plain),
            ("adler32", ADLER_PREV, zlib.adler32, cs._adler32_rows_plain)):

        def params(off, prev=prev):
            return torch.tensor([[off], [n], [prev]], dtype=torch.long,
                                device=dev)

        p_tail = params(0)

        def compare(name=name, prev=prev, zfn=zfn, plain_fn=plain_fn,
                    params=params):
            errs = []
            for rows, off in ((tail_rows, 0), (front_rows, 4096)):
                k = int(cs._checksum_rows(name, rows, params(off), n)[0])
                p = int(plain_fn(rows, [off], [n], [prev])[0])
                expect(k == zfn(data, prev),
                       f"{name} (offset {off}) differs from zlib")
                errs.append(abs(k - p))
            args = torch.tensor([[zfn(a)], [zfn(b)], [len(b)]],
                                dtype=torch.long, device=dev)
            k = int(cs._combine(name, args)[0])
            p = int(cs._combine_plain(name, args)[0])
            expect(k == zfn(data), f"{name} combine differs from zlib")
            errs.append(abs(k - p))
            return max(errs + [checksum_edges(dev, name)])

        cases.append(dict(
            name=name, source=f"tbz_torch/csrc/{name}.cu",
            replaces=("tbz/checksums.py:425" if name == "crc32"
                      else "tbz/checksums.py:385"),
            run=lambda name=name: cs._checksum_rows(name, tail_rows, p_tail, n),
            plain=lambda plain_fn=plain_fn, prev=prev: plain_fn(
                tail_rows, [0], [n], [prev]),
            compare=compare, nbytes=n + 8))
    return cases


def batch_members(payloads: list, device):
    """Tokenize payloads and stage ALL their members as one batch (the
    staging of tbz_torch.parallel.shard). Returns (its, the arguments of
    _resolve_batch)."""
    import concurrent.futures
    from tbz_torch.ops import resolve as R
    from tbz_torch.parallel import shard
    its = [(si, mi, mem) for si, p in enumerate(payloads)
           for mi, mem in enumerate(shard._tokenize_members(p, "auto"))]
    T, cap, M = (max(k) for k in zip(*(shard._bucket_key(m)
                                       for _, _, m in its)))
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        ol, di, rv, nt, tot, inp = shard._stage_bucket(its, T, M, pool)
    win = np.zeros((len(its), R.W), np.uint8)
    up = shard._upload((ol, di, rv, nt, inp, win), device)
    return its, (*up[:4], tot, up[4], up[5], cap)


def resolve_bytes_bound(its) -> int:
    """Bytes kernel 7 must move: each row's tape (12 B a token), its
    stored-block bytes and its window read once, its output written."""
    from tbz_torch.ops import resolve as R
    total = 0
    for _, _, mem in its:
        t = mem["res"].tape
        total += (12 * len(t) + stored_bytes(t.out_len, t.root_val) + R.W
                  + t.total_out)
    return total


def batch_case(dev, small: int) -> dict:
    """Kernel 7 on a batch of three 1 MiB zlib members."""
    from tbz_torch.ops import resolve as R
    datas = [corpus(SEED + 20 + i, small) for i in range(3)]
    its, args = batch_members([zlib.compress(d, 6) for d in datas], dev)

    def compare():
        k, kp = R._resolve_batch(*args)
        p, pp = R._resolve_batch_plain(*args[:4], *args[5:])
        expect(int(kp) == pp, "doubling pass counts differ")
        errs = []
        for i, d in enumerate(datas):
            expect(k[i, :len(d)].cpu().numpy().tobytes() == d,
                   "resolve_batch output differs from zlib")
            errs.append(int((k[i, :len(d)].long()
                             - p[i, :len(d)].long()).abs().max()))
        log(f"  resolve_batch: {int(kp)} doubling passes, "
            f"{[len(m['res'].tape) for _, _, m in its]} tokens")
        return max(errs + [batch_adversarial(dev)])

    return dict(name="resolve_batch", source="tbz_torch/csrc/resolve.cu",
                replaces="tbz/parallel/shard.py:33",
                run=lambda: R._resolve_batch(*args),
                plain=lambda: R._resolve_batch_plain(*args[:4], *args[5:]),
                compare=compare, nbytes=resolve_bytes_bound(its))


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def check_kernels(dev, size: int, reps: int, tok_size: int) -> list:
    """Phase 2: every kernel against its plain version on the card, at
    the shapes of a `size`-byte zlib level-6 stream's plan (the
    sequential tokenizer on bodies of `tok_size` bytes), and timed."""
    data = corpus(SEED, size)
    body = zlib.compress(data, 6)[2:-4]
    rows = []
    cases = (kernel_cases(dev, body, data)
             + checksum_cases(dev, data) + [batch_case(dev, size)]
             + [tokenize_case(dev, tok_size), flat_case(dev, body, data)])
    for c in cases:
        err = c["compare"]()
        expect(err == 0, f"{c['name']} differs from its plain version")
        ms = timed(c["run"], dev, reps)
        plain_ms = timed(c["plain"], dev, 1)
        rows.append({"name": c["name"], "route": "cuda",
                     "source": c["source"], "replaces": c["replaces"],
                     "launches": 0, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms(c["nbytes"]),
                     "bound_by": "bytes", "library_ms": None})
        log(f"  {c['name']}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
            f"bound {rows[-1]['bound_ms']:.4f} ms ({c['nbytes']} B), "
            f"max_abs_err {err}")
        if "passes" in c:
            pass_split(c)
        if "tokens" in c:
            log(f"    {c['name']}: {ms * 1e6 / c['tokens']:.1f} ns a token "
                f"({c['tokens']} tokens)")
    return rows


def pass_split(c: dict) -> dict:
    """Median of 3 of a kernel's per-pass times (CUDA events between its
    passes)."""
    runs = [c["passes"]() for _ in range(4)][1:]
    med = {k: sorted(r[k] for r in runs)[1] for k in runs[0]}
    log(f"    {c['name']} passes (ms, median of 3): " + ", ".join(
        f"{k} {v:.4f}" for k, v in med.items()))
    return med


RESOLVE_KERNELS = ("splice_resolve", "resolve_core")


def time_kernels(dev, body: bytes, data: bytes, reps: int) -> dict:
    """Kernel times at a large stream's shapes; the resolve kernels also
    against their plain versions (on the card), and the splice plan's
    upload apart from the splice + resolve kernel."""
    out = {}
    for c in kernel_cases(dev, body, data, adversarial=False):
        if c["name"] in RESOLVE_KERNELS:
            err = c["compare"]()
            expect(err == 0, f"{c['name']} differs from its plain version "
                   "at the large shape")
        ms = timed(c["run"], dev, reps)
        out[c["name"]] = {"ms": ms, "bound_ms": bound_ms(c["nbytes"]),
                          "bytes": c["nbytes"]}
        log(f"  {c['name']}: kernel {ms:.4f} ms, bound "
            f"{out[c['name']]['bound_ms']:.4f} ms ({c['nbytes']} B)")
        if "passes" in c:
            out[c["name"]]["passes_ms"] = pass_split(c)
        if "upload" in c:
            out[c["name"]]["split"] = resolve_split(c, dev)
    return out


def resolve_split(c: dict, dev) -> dict:
    """decode_stream_fused's resolve stage taken apart (median of 3 after
    a warm-up): the splice plan's upload (splice_inputs_from_numpy: the
    range table built on the host, pageable copies) and the splice +
    resolve kernel, each on the host clock up to a synchronize and
    between CUDA events."""
    import torch
    runs = []
    for _ in range(4):
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        sync(dev)
        t0 = time.perf_counter()
        if dev.type == "cuda":
            ev[0].record()
        si = c["upload"]()
        if dev.type == "cuda":
            ev[1].record()
        sync(dev)
        t1 = time.perf_counter()
        c["kernel"](si)
        if dev.type == "cuda":
            ev[2].record()
        sync(dev)
        t2 = time.perf_counter()
        r = {"upload_host_ms": (t1 - t0) * 1e3,
             "kernel_host_ms": (t2 - t1) * 1e3}
        if dev.type == "cuda":
            r["upload_event_ms"] = ev[0].elapsed_time(ev[1])
            r["kernel_event_ms"] = ev[1].elapsed_time(ev[2])
        runs.append(r)
    runs = runs[1:]
    med = {k: sorted(r[k] for r in runs)[1] for k in runs[0]}
    log("    resolve stage split (ms, median of 3): " + ", ".join(
        f"{k} {v:.3f}" for k, v in med.items()))
    return dict(med, runs=runs)


def main_streams(big: int, small: int) -> list:
    """The five streams of phases 3 and 5: (name, payload, kwargs, data)."""
    t0 = time.perf_counter()
    d_raw = corpus(SEED + 1, small)
    d_zlib = corpus(SEED + 2, small)
    d_g1, d_g2 = corpus(SEED + 3, small), corpus(SEED + 4, 40 << 10)
    mixed = mixed_stream(SEED + 5)
    d_big = corpus(SEED + 6, big)
    streams = [
        ("raw_L9_1MiB", raw_deflate(d_raw, 9), {"format": "raw"}, d_raw),
        ("zlib_L6_1MiB", zlib.compress(d_zlib, 6), {}, d_zlib),
        ("gzip_2member", gzip.compress(d_g1, 6) + gzip.compress(d_g2, 6),
         {}, d_g1 + d_g2),
        ("mixed_blocks", mixed, {"format": "raw"},
         zlib.decompress(mixed, -15)),
        (f"gzip_L6_{big // MIB}MiB", gzip.compress(d_big, 6), {}, d_big),
    ]
    log(f"data + compression {time.perf_counter() - t0:.1f} s")
    return streams


PATH_KERNELS = ("build_flat_table", "lanes_multi", "stitch_compact",
                "splice_resolve", "resolve_core", "resolve_flat")


def expect_launched(counts: dict, names, path: str) -> None:
    log(f"launch counts on {path}: {counts}")
    for k in names:
        expect(counts[k] > 0, f"kernel {k} was not launched on {path}")


def main_path(dev, streams: list, big: int) -> dict:
    """Phase 3: the public entry point with its defaults."""
    import tbz_torch
    from tbz_torch import _cuda

    results = {}
    _cuda.reset_counts()
    for name, payload, kw, want in streams:
        if dev.type != "cuda":
            kw = dict(kw, device=dev)
        t0 = time.perf_counter()
        out = tbz_torch.decompress(payload, **kw)
        ms = (time.perf_counter() - t0) * 1e3
        expect(out == want, f"{name}: output differs from zlib/gzip")
        results[name] = {"in_bytes": len(payload), "out_bytes": len(out),
                         "e2e_ms": ms}
        log(f"  {name}: {len(payload)} -> {len(out)} B, {ms:.1f} ms, "
            "byte-identical")
    counts = _cuda.launch_counts()
    if dev.type == "cuda":
        expect_launched(counts, PATH_KERNELS, "the main path")

    # after the counted run: steady-state end to end and the stage
    # breakdown of the fused decode, each the median of 3 calls (every
    # call's stages are kept, to show the spread of the host stages)
    from tbz_torch.ops import fused as F
    for name, payload, kw, _ in streams:
        if dev.type != "cuda":
            kw = dict(kw, device=dev)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            tbz_torch.decompress(payload, **kw)
            times.append((time.perf_counter() - t0) * 1e3)
        results[name]["e2e_median_ms"] = sorted(times)[1]
        body = (payload[2:-4] if name.startswith("zlib") else
                payload[10:-8] if name.startswith("gzip_L6") else None)
        if body is None:
            continue
        keys = ("scan_ms", "kernel_ms", "fetch_ms", "walk_ms",
                "resolve_ms", "out_fetch_ms")
        runs = []
        for _ in range(3):
            st = F.decode_stream_fused(body, collect_stats=True,
                                       device=dev)[4]
            r = {k: st[k] for k in keys}
            r["sum_ms"] = sum(r.values())
            runs.append(r)
        stages = {k: sorted(r[k] for r in runs)[1]
                  for k in keys + ("sum_ms",)}
        stages.update(passes=st["passes"], joins=st["joins"],
                      gap_blocks=st["gap_blocks"],
                      candidates=st["candidates"])
        results[name]["stages"] = stages
        results[name]["stage_runs"] = runs
        log(f"  {name}: e2e median {sorted(times)[1]:.1f} ms; stage "
            "medians of 3: " + ", ".join(
                f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in stages.items()))
        for k in keys + ("sum_ms",):
            log(f"    {k} over 3 calls: "
                + ", ".join(f"{r[k]:.2f}" for r in runs))
    big_body = streams[-1][1][10:-8]
    log(f"== phase 3b: kernel times at the {big // MIB} MiB stream's shapes")
    results[streams[-1][0]]["kernels"] = time_kernels(dev, big_body,
                                                      streams[-1][3], 3)
    return {"streams": results, "counts": counts}


def error_classes(dev) -> None:
    """Phase 4: truncation and a too-far distance raise zlib's class."""
    import tbz_torch
    from tbz_torch import errors as E
    kw = {} if dev.type == "cuda" else {"device": dev}
    zd = corpus(SEED + 7, 32 << 10)
    cases = {
        "truncated": zlib.compress(corpus(SEED + 8, 512 << 10), 6)[:-60000],
        "too_far": raw_deflate(zd + corpus(SEED + 9, 512 << 10), 9, zd),
    }
    for name, payload in cases.items():
        try:
            if name == "too_far":
                zlib.decompressobj(-15).decompress(payload)
            else:
                zlib.decompress(payload)
            raise Failed(f"{name}: zlib accepted the stream")
        except zlib.error as e:
            zmsg = str(e)
        fmt = "raw" if name == "too_far" else "auto"
        try:
            tbz_torch.decompress(payload, fmt, **kw)
            raise Failed(f"{name}: tbz_torch accepted the stream")
        except E.DeflateError as e:
            got = e
        if "truncated" in zmsg or "incomplete" in zmsg:
            expect(isinstance(got, E.TruncatedError),
                   f"{name}: zlib says {zmsg!r}, got {type(got).__name__}")
        else:
            expect("distance too far" in zmsg
                   and not isinstance(got, E.TruncatedError)
                   and got.code == E.ERR_BAD_DISTANCE,
                   f"{name}: zlib says {zmsg!r}, got {got!r}")
        log(f"  {name}: zlib {zmsg!r} -> {type(got).__name__}({got})")


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def resident_path(dev, streams: list, fetched_e2e_ms: float) -> dict:
    """Phase 5: decompress(device_resident=True) on the phase-3 streams,
    checksums verified on the device; the bytes are fetched only after
    the timed calls."""
    import torch
    import tbz_torch
    from tbz_torch import _cuda
    from tbz_torch import checksums as cs
    from tbz_torch import errors as E
    from tbz_torch.ops import fused as F
    dkw = {} if dev.type == "cuda" else {"device": dev}
    results, outs = {}, {}
    _cuda.reset_counts()
    for name, payload, kw, _ in streams:
        t0 = time.perf_counter()
        out = tbz_torch.decompress(payload, device_resident=True, **kw,
                                   **dkw)
        sync(dev)
        results[name] = {"e2e_ms": (time.perf_counter() - t0) * 1e3}
        expect(isinstance(out, torch.Tensor) and out.device.type
               == dev.type and out.dtype == torch.uint8,
               f"{name}: not a uint8 tensor on {dev}")
        outs[name] = out
    counts = _cuda.launch_counts()
    if dev.type == "cuda":
        expect_launched(counts, PATH_KERNELS + ("crc32", "adler32"),
                        "the device-resident path")
    big_name, big_payload, big_kw, _ = streams[-1]
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        tbz_torch.decompress(big_payload, device_resident=True, **big_kw,
                             **dkw)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    for name, _, _, want in streams:
        expect(outs[name].cpu().numpy().tobytes() == want,
               f"{name}: device-resident output differs from zlib/gzip")
        log(f"  {name}: resident, {results[name]['e2e_ms']:.1f} ms, "
            "byte-identical")
    med = sorted(times)[1]
    results[big_name].update(e2e_median_ms=med, e2e_runs_ms=times,
                             fetched_e2e_median_ms=fetched_e2e_ms)
    log(f"  {big_name}: resident e2e median of 3 {med:.1f} ms "
        f"({', '.join(f'{t:.1f}' for t in times)}); fetched (phase 3) "
        f"{fetched_e2e_ms:.1f} ms")

    body = outs[big_name]
    n = body.numel()
    rows = body.unsqueeze(0)
    for name, prev in (("crc32", 0), ("adler32", 1)):
        params = torch.tensor([[0], [n], [prev]], dtype=torch.long,
                              device=dev)
        k = {"ms": timed(lambda: cs._checksum_rows(name, rows, params, n),
                         dev, 3), "bound_ms": bound_ms(n + 8), "bytes": n}
        k["GBps"] = n / k["ms"] / 1e6
        results[big_name][name + "_kernel"] = k
        log(f"  {name} kernel alone on the {n} B resident body: "
            f"{k['ms']:.4f} ms ({k['GBps']:.1f} GB/s), bound "
            f"{k['bound_ms']:.4f} ms")

    r = F.decode_stream_fused(big_payload[10:-8], fetch=False,
                              collect_stats=True, device=dev)
    expect(r[0] is None and r[4]["out_d2h_bytes"] == 4,
           f"fetch=False moved {r[4]['out_d2h_bytes']} output bytes")
    log(f"  fetch=False: out_d2h_bytes {r[4]['out_d2h_bytes']}, "
        f"meta_d2h_bytes {r[4]['meta_d2h_bytes']}")

    two = bytearray(streams[2][1])
    two[-6] ^= 0xFF  # the second member's CRC-32
    trunc = streams[1][1][:len(streams[1][1]) // 2]
    for what, payload, cls in (("flipped CRC", bytes(two), E.ChecksumError),
                               ("truncated", trunc, E.TruncatedError)):
        try:
            tbz_torch.decompress(payload, device_resident=True, **dkw)
            raise Failed(f"{what}: device-resident decode accepted it")
        except E.DeflateError as e:
            expect(isinstance(e, cls), f"{what}: got {type(e).__name__}")
            log(f"  {what}: {type(e).__name__}({e})")
    return {"streams": results, "counts": counts}


def large_checksums(dev, size: int) -> dict:
    """Phase 6: kernels 5 and 6, tail and front, on a seeded buffer of
    more than 2^29 bytes on the device, against zlib on the host."""
    import torch
    from tbz_torch import checksums as cs
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    buf = torch.randint(0, 256, (size,), dtype=torch.uint8, device=dev,
                        generator=g)
    host = memoryview(buf.cpu().numpy())
    n = size - 4099
    expect(n > 1 << 29, "phase 6 needs more than 2^29 bytes")
    res = {"size": size, "n": n}
    for name, zfn, tail, front in (
            ("crc32", zlib.crc32, cs.crc32_device_tail, cs.crc32_device),
            ("adler32", zlib.adler32, cs.adler32_device_tail,
             cs.adler32_device)):
        expect(tail(buf, n) == zfn(host[:n]),
               f"{name} of the first {n} bytes differs from zlib")
        expect(front(buf, n) == zfn(host[size - n:]),
               f"{name} of the last {n} bytes differs from zlib")
        params = torch.tensor([[0], [n], [0 if name == "crc32" else 1]],
                              dtype=torch.long, device=dev)
        rows = buf.unsqueeze(0)
        ms = timed(lambda: cs._checksum_rows(name, rows, params, n), dev, 3)
        res[name] = {"ms": ms, "GBps": n / ms / 1e6,
                     "bound_ms": bound_ms(n + 8)}
        log(f"  {name}: tail and front of {n} B equal zlib; kernel "
            f"{ms:.3f} ms ({n / ms / 1e6:.1f} GB/s), bound "
            f"{res[name]['bound_ms']:.3f} ms")
    want = cs.crc32_combine(0x12345678, 0x9ABCDEF0, (1 << 29) + 5)
    expect(cs.crc32_combine_device(0x12345678, 0x9ABCDEF0, (1 << 29) + 5,
                                   device=dev) == want,
           "device crc32_combine at len2 = 2^29 + 5 differs from the host")
    log(f"  crc32_combine at len2 = 2^29 + 5: {want:#010x} on both")
    return res, buf, host


WBITS = {"raw": -15, "zlib": 15, "gzip": 31}


def pack(data: bytes, fmt: str, level) -> bytes:
    """`data` in raw, zlib or gzip framing at a level, or Z_FIXED."""
    if level == "fixed":
        return fixed_deflate(data, WBITS[fmt])
    co = zlib.compressobj(level, zlib.DEFLATED, WBITS[fmt])
    return co.compress(data) + co.flush()


def declined_bodies(small_max: int) -> list:
    """Phase 8a: 32 seeded payloads of 1 KB to `small_max` bytes, raw,
    zlib and gzip at levels 0, 1, 6, 9 and Z_FIXED, the sizes of HTTP
    bodies, small JSON files and log batches: (name, payload, fmt,
    data)."""
    rng = np.random.default_rng(SEED + 40)
    kinds = [(f, lv) for f in WBITS for lv in (0, 1, 6, 9, "fixed")]
    out = []
    for i in range(32):
        fmt, lv = kinds[i % len(kinds)]
        target = int(rng.integers(1024, small_max + 1))
        payload, data = fit_body(SEED + 50 + i, target,
                                 lambda d, f=fmt, lv=lv: pack(d, f, lv))
        expect(zlib.decompress(payload, WBITS[fmt]) == data, "zlib round trip")
        out.append((f"{fmt}_{lv}_{len(payload)}", payload, fmt, data))
    return out


ROUTE_KERNELS = {"auto": ("resolve_flat",),
                 "device": ("tokenize_device", "build_flat_table",
                            "lanes_multi", "resolve_flat")}


def use_frontend(fe: str) -> None:
    from tbz_torch.utils import config as C
    C.set_config(C.Config(frontend=fe))


def declined_stages(dev, body: bytes, data: bytes, fe: str) -> dict:
    """The declined route of one body in stages, each ended by a
    synchronize: tokenize (frontend `fe`), plan (C++ flat planner), H2D
    (the staged plan), resolve (the flat span kernel), fetch."""
    from tbz_torch import frontend
    from tbz_torch.native import loader as NL
    from tbz_torch.ops import resolve_spans as RS
    st = {}
    t0 = time.perf_counter()
    res = frontend.tokenize(body, 0, 0, frontend=fe, device=dev)
    sync(dev)
    st["tokenize_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plan = NL.plan_spans_flat(res.tape, body)
    st["plan_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    staged = RS.stage_flat_plan(plan)
    fa = RS.flat_plan_from_numpy(staged, dev)
    sync(dev)
    st["h2d_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out = RS._resolve_flat_impl(fa)
    sync(dev)
    st["resolve_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    host = out[:plan.total_out].cpu().numpy().tobytes()
    st["fetch_ms"] = (time.perf_counter() - t0) * 1e3
    expect(host == data, f"declined stages ({fe}): output differs from zlib")
    st["sum_ms"] = sum(st.values())
    st.update(tokens=len(res.tape), spans=plan.n_spans,
              batches=plan.n_batches, segments=len(fa.seg_base),
              h2d_bytes=sum(a.nbytes for a in staged[:3]) + staged[6].nbytes)
    return st


def declined_route(dev, d_big: bytes, fixed_gz: bytes, small_max: int,
                   spec_big: int) -> dict:
    """Phase 8a-b: the route of the bodies the fused decode declines,
    through decompress with the default frontend and with
    frontend="device": 32 small bodies, and `d_big` as a static-only
    (`fixed_gz`) and a stored-only gzip stream (the device frontend's run
    of the static one on its first `spec_big` bytes of data)."""
    import tbz_torch
    from tbz_torch import _cuda
    dkw = {} if dev.type == "cuda" else {"device": dev}
    t0 = time.perf_counter()
    bodies = declined_bodies(small_max)
    bigs = {"auto": [("gzip_fixed", fixed_gz, d_big),
                     ("gzip_L0", gzip.compress(d_big, 0), d_big)]}
    d_spec = d_big[:spec_big]
    bigs["device"] = [("gzip_fixed", fixed_deflate(d_spec, 31)
                       if spec_big < len(d_big) else fixed_gz,
                       d_spec), bigs["auto"][1]]
    log(f"  32 bodies of {min(len(b[1]) for b in bodies)} to "
        f"{max(len(b[1]) for b in bodies)} B; "
        + ", ".join(f"{n} {len(p)} B" for n, p, _ in bigs["auto"])
        + f"; data + compression {time.perf_counter() - t0:.1f} s")
    res = {"small": {}, "big": {}, "counts": {}}
    try:
        for fe in ("auto", "device"):
            use_frontend(fe)
            _cuda.reset_counts()
            for name, payload, fmt, data in bodies:
                expect(tbz_torch.decompress(payload, fmt, **dkw) == data,
                       f"{name} ({fe}): output differs from zlib")
            e2e, route = {}, {}
            for name, payload, data in bigs[fe]:
                # the fused decode takes a stream whose header scan finds
                # a candidate, even a false one in stored bytes
                spliced = _cuda.launch_counts()["splice_resolve"]
                t0 = time.perf_counter()
                out = tbz_torch.decompress(payload, **dkw)
                e2e[name] = (time.perf_counter() - t0) * 1e3
                expect(out == data, f"{name} ({fe}): output differs")
                route[name] = ("fused" if _cuda.launch_counts()
                               ["splice_resolve"] > spliced else "declined")
                log(f"  {name} ({fe}): {len(payload)} -> {len(out)} B, "
                    f"{e2e[name]:.1f} ms, byte-identical, {route[name]} "
                    "route")
            counts = _cuda.launch_counts()
            if dev.type == "cuda":
                expect_launched(counts, ROUTE_KERNELS[fe],
                                f"the declined route ({fe})")
            res["counts"][fe] = counts
            log(f"  32 bodies ({fe}): byte-identical to zlib")
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _, payload, fmt, _ in bodies:
                    tbz_torch.decompress(payload, fmt, **dkw)
                times.append((time.perf_counter() - t0) * 1e3)
            res["small"][fe] = {
                "e2e_median_ms": sorted(times)[1], "e2e_runs_ms": times,
                "bodies": len(bodies),
                "in_bytes": sum(len(b[1]) for b in bodies),
                "out_bytes": sum(len(b[3]) for b in bodies)}
            log(f"  32 bodies ({fe}): e2e median of 3 "
                f"{sorted(times)[1]:.1f} ms for all 32 "
                f"({', '.join(f'{t:.1f}' for t in times)})")
            name, payload, _, data = max((b for b in bodies if b[2] == "raw"),
                                         key=lambda b: len(b[1]))
            st = declined_stages(dev, payload, data, fe)
            res["small"][fe]["largest_raw"] = dict(name=name, stages=st)
            log(f"  {name} ({fe}) stages: " + ", ".join(
                f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in st.items()))
            for name, payload, data in bigs[fe]:
                st = declined_stages(dev, payload[10:-8], data, fe)
                res["big"][f"{name}/{fe}"] = {
                    "in_bytes": len(payload), "out_bytes": len(data),
                    "e2e_ms": e2e[name], "route": route[name],
                    "stages": st}
                log(f"  {name} ({fe}) stages: " + ", ".join(
                    f"{k} {v:.1f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in st.items()))
    finally:
        use_frontend("auto")
    return res


def flat_vs_core(dev, body: bytes, data: bytes) -> dict:
    """Phase 8c: the flat span resolver and pointer doubling on the same
    tape (the 64 MiB static-only stream's), each call timed with CUDA
    events, in turns: flat, core, flat, core, flat, core."""
    import torch
    from tbz_torch.native import loader as NL
    from tbz_torch.ops import resolve as R
    from tbz_torch.ops import resolve_spans as RS
    tape = NL.tokenize(body).tape
    plan = NL.plan_spans_flat(tape, body)
    fa = RS.flat_plan_from_numpy(RS.stage_flat_plan(plan), dev)
    T = R._pad_pow2(len(tape))
    cap = R._pad_pow2(tape.total_out, floor=4096)

    def up(a):
        z = np.zeros(T, np.int32)
        z[:len(a)] = a
        return torch.from_numpy(z).to(dev)

    rargs = (up(tape.out_len), up(tape.dist), up(tape.root_val), len(tape),
             torch.from_numpy(np.frombuffer(body, np.uint8).copy()).to(dev),
             R.window_tensor(b"", dev), cap)
    n = tape.total_out
    kf = RS._resolve_flat_impl(fa)
    expect(kf[:n].cpu().numpy().tobytes() == data,
           "flat resolve differs from zlib")
    expect(max_abs_err(kf, RS._resolve_flat_plain(fa)) == 0,
           "flat resolve differs from its plain version")
    kr, passes = R._resolve_core(*rargs)
    expect(kr[R.W:R.W + n].cpu().numpy().tobytes() == data,
           "doubling resolve differs from zlib")
    pr, pp = R._resolve_core_plain(*rargs)
    expect(int(passes) == pp and max_abs_err(kr, pr) == 0,
           f"doubling resolve differs from its plain version ({int(passes)}"
           f" passes, plain {pp})")
    log(f"  both equal their plain versions on the card ({pp} passes)")
    del kr, pr, kf
    flat_ms, core_ms = [], []
    for _ in range(3):
        flat_ms.append(timed(lambda: RS._resolve_flat_impl(fa), dev, 1,
                             warm=False))
        core_ms.append(timed(lambda: R._resolve_core(*rargs), dev, 1,
                             warm=False))
    r = {"tokens": len(tape), "out_bytes": n, "spans": plan.n_spans,
         "batches": plan.n_batches, "doubling_passes": int(passes),
         "flat_ms": flat_ms, "core_ms": core_ms,
         "flat_median_ms": sorted(flat_ms)[1],
         "core_median_ms": sorted(core_ms)[1],
         "flat_bound_ms": bound_ms(flat_plan_bytes(plan, 0)),
         "core_bound_ms": bound_ms(12 * len(tape) + n)}
    log(f"  resolve_flat {', '.join(f'{t:.2f}' for t in flat_ms)} ms; "
        f"resolve_core {', '.join(f'{t:.2f}' for t in core_ms)} ms "
        f"({r['doubling_passes']} passes) on {n} B, {len(tape)} tokens, "
        f"{plan.n_batches} batches")
    return r


class LaneCallTimer:
    """While active, wraps ops/speculative._lanes_fused (the speculative
    tier's one device call a block: build_flat_table with B = 1, then
    lanes_multi) with CUDA events, and counts the bytes each call must
    move: the code lengths read and both tables written, each lane's
    bits read, the flat result written."""

    def __init__(self, dev):
        self.dev, self.calls, self.nbytes, self.spans = dev, [], 0, []

    def __enter__(self):
        import torch
        from tbz_torch.ops import speculative as SP
        self.orig = orig = SP._lanes_fused

        def wrapped(data32, lit_pad, dist_pad, lane_starts, lane_ends,
                    total_bits, L, max_syms):
            if self.dev.type == "cuda":
                ev = [torch.cuda.Event(enable_timing=True) for _ in "se"]
                ev[0].record()
            else:
                ev = time.perf_counter()
            out = orig(data32, lit_pad, dist_pad, lane_starts, lane_ends,
                       total_bits, L, max_syms)
            if self.dev.type == "cuda":
                ev[1].record()
            else:
                ev = (time.perf_counter() - ev) * 1e3
            self.calls.append(ev)
            self.spans.append(lane_ends - lane_starts)
            self.nbytes += (4 * 320 + 2 * 4 * (1 << 15)
                            + 4 * (3 * L * max_syms + 2 * L + 2))
            return out

        SP._lanes_fused = wrapped
        return self

    def __exit__(self, *exc):
        from tbz_torch.ops import speculative as SP
        SP._lanes_fused = self.orig

    def result(self) -> dict:
        sync(self.dev)
        ms = [c if isinstance(c, float) else c[0].elapsed_time(c[1])
              for c in self.calls]
        lane_bytes = sum(int(x.sum()) for x in self.spans) // 8
        return {"calls": len(ms), "ms": sum(ms),
                "bound_ms": bound_ms(self.nbytes + lane_bytes)}


def declined_kernel_times(dev, d_big: bytes, fixed_body: bytes,
                          fvc: dict) -> dict:
    """Phase 8e: the declined route's kernels at the 63 KB and the 64 MiB
    static-only stream's shapes, CUDA events after a synchronize:
    tokenize_device (one call on each body), resolve_flat (the 63 KB
    body's plan; phase 8c timed the 64 MiB one, `fvc`), and the
    speculative tier's per-block call summed over the blocks of each
    body."""
    import torch
    from tbz_torch.native import loader as NL
    from tbz_torch.ops import resolve as R
    from tbz_torch.ops import resolve_spans as RS
    from tbz_torch.ops import speculative as SP
    from tbz_torch.ops import tokenize_device as TD
    small, d_small = fit_body(SEED + 34, 63 << 10, fixed_deflate)
    out = {}
    for size, body, data in (("63KB", small, d_small),
                             ("64MiB", fixed_body, d_big)):
        w = TD.stage_words(body, dev)
        T = 1 << max(10, len(body).bit_length())
        got = {}
        tok_ms = timed(lambda: got.update(r=TD.tokenize_device_impl(
            w, len(body) * 8, 0, T)), dev, 1, warm=False)
        tape, res = got["r"]
        n_tok = int(res[0])
        expect(int(res[1]) == len(data) and int(res[3]) == 0,
               f"tokenize_device at {size}: {res.tolist()}")
        # the kernel's tape resolved (resolve_core) equals zlib's bytes
        inp = torch.from_numpy(np.frombuffer(body, np.uint8).copy()).to(dev)
        rout, _ = R._resolve_core(tape[0], tape[1], tape[2], n_tok, inp,
                                  R.window_tensor(b"", dev),
                                  R._pad_pow2(len(data), floor=4096))
        expect(rout[R.W:R.W + len(data)].cpu().numpy().tobytes() == data,
               f"tokenize_device at {size}: the resolved tape differs "
               "from zlib")
        del tape, rout
        if body is small:
            plan = NL.plan_spans_flat(NL.tokenize(body).tape, body)
            fa = RS.flat_plan_from_numpy(RS.stage_flat_plan(plan), dev)
            expect(max_abs_err(RS._resolve_flat_impl(fa),
                               RS._resolve_flat_plain(fa)) == 0,
                   "resolve_flat differs from its plain version at 63 KB")
            flat = {"ms": timed(lambda: RS._resolve_flat_impl(fa), dev, 3),
                    "batches": plan.n_batches,
                    "bound_ms": bound_ms(flat_plan_bytes(plan, 0))}
        else:
            flat = {"ms": fvc["flat_median_ms"], "batches": fvc["batches"],
                    "bound_ms": fvc["flat_bound_ms"]}
        with LaneCallTimer(dev) as lt:
            r = SP.tokenize_stream_speculative(body, device=dev)
        expect(r.tape.total_out == len(data), f"speculative at {size}")
        out[size] = {
            "body_bytes": len(body), "tokens": n_tok,
            "tokenize_device": {"ms": tok_ms, "bound_ms": bound_ms(
                len(body) + 12 * n_tok + 20),
                "ns_per_token": tok_ms * 1e6 / max(n_tok, 1)},
            "resolve_flat": flat, "lanes_fused": lt.result()}
        log(f"  {size} static body ({len(body)} B, {n_tok} tokens): "
            f"tokenize_device {tok_ms:.3f} ms "
            f"({tok_ms * 1e6 / max(n_tok, 1):.1f} ns a token, its tape "
            f"resolved equal to zlib); resolve_flat "
            f"{flat['ms']:.3f} ms ({flat['batches']} batches); speculative "
            f"{out[size]['lanes_fused']['calls']} block calls, "
            f"{out[size]['lanes_fused']['ms']:.3f} ms in all")
    return out


def declined_errors(dev) -> None:
    """Phase 8d: error classes through frontend="device" (the sequential
    tokenizer) against zlib's messages."""
    import tbz_torch
    from tbz_torch import _cuda
    from tbz_torch import errors as E
    dkw = {} if dev.type == "cuda" else {"device": dev}
    zd = corpus(SEED + 71, 8 << 10)
    trunc = raw_deflate(corpus(SEED + 70, 40 << 10), 6)
    cases = (
        ("truncated", trunc[:len(trunc) // 2], "truncated",
         lambda e: isinstance(e, E.TruncatedError)),
        ("too_far", raw_deflate(zd + corpus(SEED + 72, 20 << 10), 9, zd),
         "distance too far", lambda e: e.code == E.ERR_BAD_DISTANCE),
        ("block_type_3", b"\x07" + bytes(8), "invalid block type",
         lambda e: e.code == E.ERR_BAD_BLOCK_TYPE),
        ("single_1bit_cl_code", single_bit_cl_header(),
         "invalid code lengths set",
         lambda e: e.code == E.ERR_BAD_HUFFMAN))
    use_frontend("device")
    _cuda.reset_counts()
    try:
        for name, payload, zword, ok in cases:
            try:
                zlib.decompress(payload, -15)
                raise Failed(f"{name}: zlib accepted the stream")
            except zlib.error as e:
                zmsg = str(e)
            expect(zword in zmsg, f"{name}: zlib says {zmsg!r}")
            try:
                tbz_torch.decompress(payload, "raw", **dkw)
                raise Failed(f"{name}: tbz_torch accepted the stream")
            except E.DeflateError as e:
                expect(ok(e), f"{name}: zlib says {zmsg!r}, got {e!r}")
                log(f"  {name}: zlib {zmsg!r} -> {type(e).__name__}({e})")
    finally:
        use_frontend("auto")
    if dev.type == "cuda":
        expect(_cuda.launch_counts()["tokenize_device"] == len(cases),
               "the error cases did not all run the sequential tokenizer")


# The twelve files of the Silesia corpus and their sizes in bytes; only
# the sizes are used (the data is seeded, Silesia is not in the repo).
SILESIA = (("dickens", 10192446), ("mozilla", 51220480), ("mr", 9970564),
           ("nci", 33553445), ("ooffice", 6152192), ("osdb", 10085684),
           ("reymont", 6627202), ("samba", 21606400), ("sao", 7251944),
           ("webster", 41458703), ("xml", 5345280), ("x-ray", 8474240))
ZLIB_FILES = ("nci", "xml")
RAW_FILES = ("x-ray",)
TWO_MEMBER = ("mozilla", "webster")


def silesia_batch(scale: float = 1.0) -> tuple:
    """Twelve seeded streams at the Silesia files' sizes (times `scale`):
    nine gzip (two of them two-member), two zlib, one raw."""
    import concurrent.futures
    t0 = time.perf_counter()
    sizes = [(name, max(4096, int(n * scale))) for name, n in SILESIA]
    datas = [corpus(SEED + 100 + i, n) for i, (_, n) in enumerate(sizes)]

    def pack(item):
        (name, _), d = item
        if name in ZLIB_FILES:
            return zlib.compress(d, 6)
        if name in RAW_FILES:
            return raw_deflate(d, 6)
        if name in TWO_MEMBER:
            h = len(d) // 2
            return gzip.compress(d[:h], 6) + gzip.compress(d[h:], 6)
        return gzip.compress(d, 6)

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        payloads = list(pool.map(pack, zip(sizes, datas)))
    log(f"Silesia-shaped batch: {sum(len(d) for d in datas)} B in "
        f"{sum(len(p) for p in payloads)} B, data + compression "
        f"{time.perf_counter() - t0:.1f} s")
    return [n for n, _ in sizes], payloads, datas


def batched_path(dev, batch: tuple) -> tuple:
    """Phase 7: decode_streams_sharded on the Silesia-shaped batch
    (names, payloads, datas) over a one-entry mesh of `dev`. Returns
    (results, the outputs)."""
    import concurrent.futures
    import torch
    from tbz_torch import _cuda
    from tbz_torch import errors as E
    from tbz_torch.ops import resolve as R
    from tbz_torch.parallel import shard
    from tbz_torch.parallel.mesh import make_mesh
    names, payloads, datas = batch
    total = sum(len(d) for d in datas)
    one = make_mesh(devices=[dev])
    _cuda.reset_counts()
    t0 = time.perf_counter()
    outs = shard.decode_streams_sharded(payloads, one)
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = _cuda.launch_counts()
    for name, o, d in zip(names, outs, datas):
        expect(o == d, f"{name}: batched output differs from zlib")
    log(f"  all {len(outs)} streams byte-identical ({first_ms:.1f} ms)")
    if dev.type == "cuda":
        expect_launched(counts, ("resolve_batch", "crc32", "adler32"),
                        "the batched member path")

    bad = list(payloads)
    k = names.index("dickens")
    b = bytearray(bad[k])
    b[-6] ^= 0xFF  # its CRC-32
    bad[k] = bytes(b)
    outs2 = shard.decode_streams_sharded(bad, one, return_errors=True)
    expect(isinstance(outs2[k], E.DeflateError),
           f"corrupt CRC gave {type(outs2[k]).__name__}")
    expect(all(o == d for i, (o, d) in enumerate(zip(outs2, datas))
               if i != k), "a healthy stream differs next to a corrupt one")
    log(f"  corrupt CRC at {k}: {type(outs2[k]).__name__}, others intact")

    res_outs = shard.decode_streams_sharded(payloads, one,
                                            device_resident=True)
    for name, members, d in zip(names, res_outs, datas):
        expect(all(isinstance(t, torch.Tensor) and t.device.type
                   == dev.type for t, _ in members), f"{name}: not on {dev}")
        got = b"".join(t[:n].cpu().numpy().tobytes() for t, n in members)
        expect(got == d, f"{name}: device-resident output differs")
    log("  device_resident=True: every member a row on the device, "
        "byte-identical")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        shard.decode_streams_sharded(payloads, one)
        times.append((time.perf_counter() - t0) * 1e3)
    med = sorted(times)[1]
    log(f"  e2e median of 3 {med:.1f} ms ({', '.join(f'{t:.1f}' for t in times)}), "
        f"{total / med / 1e6:.3f} GB/s of output")

    # stage split, each stage after a synchronize
    st = dict(tokenize_ms=0.0, stage_h2d_ms=0.0, resolve_ms=0.0,
              checksum_ms=0.0, fetch_ms=0.0)
    buckets_info, largest = [], None
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        t0 = time.perf_counter()
        per = list(pool.map(lambda p: shard._tokenize_members(p, "auto"),
                            payloads))
        st["tokenize_ms"] = (time.perf_counter() - t0) * 1e3
        buckets: dict = {}
        for si, mems in enumerate(per):
            for mi, mem in enumerate(mems):
                buckets.setdefault(shard._bucket_key(mem), []).append(
                    (si, mi, mem))
        for (T, cap, M), its in buckets.items():
            t0 = time.perf_counter()
            ol, di, rv, nt, tot, inp = shard._stage_bucket(its, T, M, pool)
            win = np.zeros((len(its), R.W), np.uint8)
            up = shard._upload((ol, di, rv, nt, inp, win), dev)
            sync(dev)
            st["stage_h2d_ms"] += (time.perf_counter() - t0) * 1e3
            args = (*up[:4], tot, up[4], up[5], cap)
            t0 = time.perf_counter()
            bodies, passes = R._resolve_batch(*args)
            sync(dev)
            st["resolve_ms"] += (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            kinds = {m["kind"] for _, _, m in its}
            if "crc32" in kinds:
                shard._crc_batch(bodies, tot).cpu()
            if "adler32" in kinds:
                shard._adler_batch(bodies, tot).cpu()
            st["checksum_ms"] += (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            for i in range(len(its)):
                bodies[i, :int(tot[i])].cpu()
            st["fetch_ms"] += (time.perf_counter() - t0) * 1e3
            # kernel 7 against its plain version at this bucket's shape
            # (not timed as a stage): the batch's pass count, and each
            # row's bytes in [0, total_out)
            t0 = time.perf_counter()
            pbodies, ppasses = R._resolve_batch_plain(*args[:4], *args[5:])
            sync(dev)
            plain_ms = (time.perf_counter() - t0) * 1e3
            expect(int(passes) == ppasses, f"bucket cap {cap}: doubling "
                   f"pass counts differ ({int(passes)} != {ppasses})")
            err = max(int((bodies[i, :n].long() - pbodies[i, :n].long())
                          .abs().max()) if n else 0
                      for i, n in enumerate(int(t) for t in tot))
            del pbodies
            expect(err == 0, f"bucket cap {cap}: resolve_batch differs "
                   "from its plain version")
            info = {"T": T, "cap": cap, "M": M, "rows": len(its),
                    "out_bytes": int(tot.sum()), "passes": int(passes),
                    "max_abs_err": err, "plain_ms": plain_ms}
            buckets_info.append(info)
            if largest is None or len(its) * cap > largest[0]:
                largest = (len(its) * cap, info, its, args, bodies, tot)
    st["sum_ms"] = sum(st.values())
    log("  stages: " + ", ".join(f"{k} {v:.1f}" for k, v in st.items()))
    log(f"  {len(buckets_info)} buckets: " + "; ".join(
        f"{b['rows']} x cap {b['cap']} ({b['passes']} passes, plain "
        f"{b['plain_ms']:.1f} ms, max_abs_err {b['max_abs_err']})"
        for b in buckets_info))

    _, info, its, args, bodies, tot = largest
    nb = sum(int(t) for t in tot)
    kt = {"rows": info["rows"], "cap": info["cap"], "out_bytes": nb,
          "resolve_batch": {"ms": timed(lambda: R._resolve_batch(*args),
                                        dev, 3),
                            "bound_ms": bound_ms(resolve_bytes_bound(its)),
                            "passes": info["passes"],
                            "plain_ms": info["plain_ms"],
                            "max_abs_err": info["max_abs_err"]}}
    for name, fn in (("crc32", shard._crc_batch),
                     ("adler32", shard._adler_batch)):
        kt[name] = {"ms": timed(lambda: fn(bodies, tot), dev, 3),
                    "bound_ms": bound_ms(nb + 8 * len(tot))}
    log(f"  largest bucket ({info['rows']} rows x cap {info['cap']}, "
        f"{nb} B): " + ", ".join(
            f"{k} {v['ms']:.3f} ms (bound {v['bound_ms']:.3f})"
            for k, v in kt.items() if isinstance(v, dict)))
    return {"counts": counts, "out_bytes": total, "e2e_median_ms": med,
            "e2e_runs_ms": times, "first_call_ms": first_ms,
            "GBps": total / med / 1e6, "stages": st,
            "buckets": buckets_info, "largest_bucket": kt}, outs


def mesh_of_four(dev):
    """Phase 9a's mesh: the card's own devices where there are 4 or
    more, otherwise `dev` named four times (tbz's tests stand virtual
    devices in for chips the same way)."""
    import torch
    from tbz_torch.parallel.mesh import make_mesh
    if dev.type == "cuda" and torch.cuda.device_count() >= 4:
        return make_mesh(4)
    return make_mesh(devices=[dev] * 4)


def sharded_checksums(dev, buf, host) -> tuple:
    """Phase 9a: make_sharded_crc32 / make_sharded_adler32 over a mesh of
    4 entries on phase 6's buffer (more than 2^29 bytes, where tbz's
    uint32 8·n wraps): n = all of it, 777 bytes less, 5000 and 0 against
    zlib; each call's time, the per-shard kernel time and the combine
    tree's (2 levels)."""
    import torch
    from tbz_torch import _cuda
    from tbz_torch import checksums as cs
    from tbz_torch.parallel import shard
    mesh = mesh_of_four(dev)
    size = buf.numel()
    C = size // 4
    log(f"  mesh {mesh.shape}: {mesh.devices.reshape(-1).tolist()}, "
        f"{C} B a shard")
    fns = {"crc32": (shard.make_sharded_crc32(mesh, size), zlib.crc32),
           "adler32": (shard.make_sharded_adler32(mesh, size), zlib.adler32)}
    res = {"mesh": str(mesh.devices.reshape(-1).tolist()), "size": size}
    _cuda.reset_counts()
    for name, (fn, zfn) in fns.items():
        calls = {}
        for n in (size, size - 777, 5000, 0):
            t0 = time.perf_counter()
            got = fn(buf, n)
            ms = (time.perf_counter() - t0) * 1e3
            expect(got == zfn(host[:n]),
                   f"sharded {name} of {n} bytes differs from zlib")
            calls[str(n)] = ms
            log(f"  sharded {name} of {n} B: {got:#010x} = zlib, "
                f"{ms:.3f} ms (call, host clock)")
        res[name] = {"call_ms": calls}
    counts = _cuda.launch_counts()
    if dev.type == "cuda":
        expect_launched(counts, ("crc32", "adler32"),
                        "the sharded checksums")
    rows = buf[:C].unsqueeze(0)
    for name, prev in (("crc32", 0), ("adler32", 1)):
        params = torch.tensor([[0], [C], [prev]], dtype=torch.long,
                              device=dev)
        shard_ms = timed(lambda: cs._checksum_rows(name, rows, params, C),
                         dev, 3)
        vals = torch.full((4,), prev, dtype=torch.long, device=dev)
        lens = torch.full((4,), C, dtype=torch.long, device=dev)
        fold_ms = timed(lambda: shard._fold(name, vals, lens), dev, 10)
        res[name].update(shard_kernel_ms=shard_ms, fold_ms=fold_ms,
                         fold_levels=2, shard_bound_ms=bound_ms(C + 8))
        log(f"  {name}: per-shard kernel {shard_ms:.4f} ms on {C} B "
            f"(bound {bound_ms(C + 8):.4f} ms), combine tree (2 levels) "
            f"{fold_ms:.4f} ms")
    return res, counts


def mesh_worker(rank: int, world: int, port: int, device_type: str,
                shard_bytes: int) -> int:
    """Phase 9b, one process of the group: join the group (NCCL on a
    card, gloo on the CPU), build the global mesh, run the sharded
    checksums over it (partials all-gathered over the group) and the
    mesh-wide resolve batch of a small multi-stream set, checking this
    process's rows byte for byte. Prints an OK line."""
    import concurrent.futures
    import torch
    import torch.distributed as dist
    from tbz_torch import _cuda
    from tbz_torch.parallel import distributed, shard
    distributed.initialize(f"localhost:{port}", world, rank,
                           device_type=device_type, force=True)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    mesh = distributed.global_mesh()
    expect(mesh.group is not None and mesh.size == world,
           f"global mesh {mesh}")
    _cuda.reset_counts()
    N = shard_bytes * world
    arr = np.random.default_rng(SEED + 200).integers(0, 256, N,
                                                     dtype=np.uint8)
    mine = [torch.from_numpy(arr[rank * shard_bytes:
                                 (rank + 1) * shard_bytes]).to(dev)]
    sums = {}
    for name, make, zfn in (("crc32", shard.make_sharded_crc32, zlib.crc32),
                            ("adler32", shard.make_sharded_adler32,
                             zlib.adler32)):
        fn = make(mesh, N)
        for n in (N - 777, 5000):
            got = fn(mine, n)
            expect(got == zfn(memoryview(arr)[:n]),
                   f"rank {rank}: sharded {name} of {n} B differs")
        sums[name] = hex(got)
    streams = [corpus(SEED + 210 + i, 150_000 + 40_000 * i)
               for i in range(2 * world + 1)]
    its = [(si, mi, m) for si, d in enumerate(streams)
           for mi, m in enumerate(shard._tokenize_members(
               zlib.compress(d, 6), "zlib"))]
    T, cap, M = (max(k) for k in zip(*(shard._bucket_key(m)
                                       for _, _, m in its)))
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        staged = shard._stage_bucket(its, T, M, pool)
    seen = []
    for lo, hi, bodies in shard._resolve_batch_on_mesh(mesh, staged, cap):
        for k in range(hi - lo):
            n = int(staged[4][lo + k])
            expect(bodies[k, :n].cpu().numpy().tobytes() == streams[lo + k],
                   f"rank {rank}: row {lo + k} differs from zlib")
            seen.append(lo + k)
    counts = _cuda.launch_counts()
    if device_type == "cuda":
        expect_launched(counts, ("crc32", "adler32", "resolve_batch"),
                        f"rank {rank}")
    backend = dist.get_backend()
    dist.destroy_process_group()
    print(f"MESH-OK rank={rank} world={world} backend={backend} "
          f"device={dev} rows={seen} {json.dumps(sums)}", flush=True)
    return 0


def process_group(dev, shard_bytes: int) -> dict:
    """Phase 9b: one process per local card (two gloo processes for a
    CPU rehearsal), each `chip_smoke.py --mesh-worker`, under a timeout;
    every process must exit 0 and print its OK line."""
    import socket
    import torch
    world = torch.cuda.device_count() if dev.type == "cuda" else 2
    if dev.type == "cuda":
        torch.cuda.empty_cache()   # leave the workers the card's memory
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "chip_smoke.py"),
         "--mesh-worker", str(r), str(world), str(port), dev.type,
         str(shard_bytes)], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        ok = [ln for ln in out.splitlines() if ln.startswith("MESH-OK")]
        expect(p.returncode == 0 and ok,
               f"group rank {r} failed (rc {p.returncode}):\n{out[-3000:]}")
        log(f"  {ok[0]}")
    log(f"  {world} process(es), {wall:.1f} s wall")
    return {"world": world, "wall_s": wall,
            "ok": [ln for o in outs for ln in o.splitlines()
                   if ln.startswith("MESH-OK")]}


def mesh_decode(dev, batch: tuple, ref_outs: list, ref_med: float) -> tuple:
    """Phase 9c: decode_streams_sharded(payloads, mesh) on phase 7's
    batch over every local card and over `dev` named twice: byte-identical
    to zlib and to phase 7's one-card output, e2e median of 3 beside
    phase 7's."""
    from tbz_torch import _cuda
    from tbz_torch.parallel import shard
    from tbz_torch.parallel.mesh import make_mesh
    names, payloads, datas = batch
    total = sum(len(d) for d in datas)
    meshes = (("every local card", make_mesh() if dev.type == "cuda"
               else make_mesh(devices=[dev])),
              (f"{dev} twice", make_mesh(devices=[dev] * 2)))
    res, counts = {}, {}
    for label, mesh in meshes:
        _cuda.reset_counts()
        outs = shard.decode_streams_sharded(payloads, mesh)
        counts[label] = _cuda.launch_counts()
        for name, o, d, r in zip(names, outs, datas, ref_outs):
            expect(o == d and o == r,
                   f"{name} over {label}: differs from zlib or phase 7")
        if dev.type == "cuda":
            expect_launched(counts[label], ("resolve_batch", "crc32",
                                            "adler32"), f"the mesh ({label})")
        del outs
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            shard.decode_streams_sharded(payloads, mesh)
            times.append((time.perf_counter() - t0) * 1e3)
        med = sorted(times)[1]
        res[label] = {"mesh": str(mesh.devices.reshape(-1).tolist()),
                      "e2e_median_ms": med, "e2e_runs_ms": times,
                      "GBps": total / med / 1e6}
        log(f"  {label} {mesh.shape}: all {len(names)} streams equal zlib "
            f"and phase 7; e2e median of 3 {med:.1f} ms ("
            f"{', '.join(f'{t:.1f}' for t in times)}); phase 7 "
            f"{ref_med:.1f} ms")
    return res, counts


def flat_layouts(dev, body: bytes, data: bytes, reps: int) -> dict:
    """Phase 10b: the flat resolve through tbz's two other argument
    layouts (ops/resolve_spans._resolve_flat_scan_impl, a segment row a
    batch; _resolve_flat_gscat_impl, absolute rows) on the plan of
    `body`: the same rows as _resolve_flat_impl, zlib's bytes, and the
    times of the three, in turns."""
    from tbz_torch.native import loader as NL
    from tbz_torch.ops import resolve_spans as RS
    plan = NL.plan_spans_flat(NL.tokenize(body).tape, body)
    st = RS.stage_flat_plan(plan)
    fa = RS.flat_plan_from_numpy(st, dev)
    srcaddr, lenoff, g_rows = fa.srcaddr, fa.lenoff, fa.g_rows
    b_segrow = np.asarray(plan.b_segrow, np.int32)
    g_glob = (st[2] + b_segrow[:, None]).astype(np.int32)
    out0 = st[6].view("<u4").reshape(-1, 32)
    wrows = st[7].view("<u4").reshape(RS.W_ROWS, 32)
    n_rows = out0.shape[0]
    calls = {
        "flat": lambda: RS._resolve_flat_impl(fa),
        "scan": lambda: RS._resolve_flat_scan_impl(
            srcaddr, lenoff, g_rows, b_segrow, out0, wrows, n_rows,
            plan.seg_rows),
        "gscat": lambda: RS._resolve_flat_gscat_impl(
            srcaddr, lenoff, g_glob, out0, wrows, n_rows)}
    ref = calls["flat"]()
    expect(ref[:plan.total_out].cpu().numpy().tobytes() == data,
           "resolve_flat differs from zlib")
    expect(max_abs_err(ref, RS._resolve_flat_plain(fa)) == 0,
           "resolve_flat differs from its plain version")
    for name in ("scan", "gscat"):
        expect(max_abs_err(calls[name](), ref) == 0,
               f"the {name} layout differs from _resolve_flat_impl")
    res = {k: [] for k in calls}
    for _ in range(reps):
        for k, fn in calls.items():
            res[k].append(timed(fn, dev, 1, warm=False))
    out = {k: {"median_ms": sorted(v)[len(v) // 2], "ms": v}
           for k, v in res.items()}
    out["batches"] = plan.n_batches
    log("  scan and gscat layouts equal _resolve_flat_impl and zlib on "
        f"the {len(data)} B plan ({plan.n_batches} batches); medians of "
        f"{reps} in turns: " + ", ".join(
            f"{k} {v['median_ms']:.4f} ms" for k, v in out.items()
            if isinstance(v, dict)))
    return out


ROWGATHER = {"copy": "copy_rows", "rot": "rot_rows", "accum": "accum_rows",
             "grid": "grid_rows"}


def rowgather_bytes(which: str, t: dict) -> int:
    """Least bytes a probe must move on inputs `t`: each distinct table
    row it gathers read once (128 B; nearly all R rows at N = 4R), 4 B a
    row of each index vector (idx; rot or dst too) and N rows of 128 B
    written."""
    import torch
    idx, R = t["idx"], t["tbl"].shape[0]
    used = torch.unique(idx[(idx >= 0) & (idx < R)]).numel()
    N = idx.shape[0]
    return 128 * used + 4 * N * (1 if which in ("copy", "grid") else 2) \
        + 128 * N


def gather_bytes(which: str, N: int) -> int:
    """Bytes of the rows as gathered: N table rows of 128 B read (the
    table outgrows L2 at N=2^22, so rows come from HBM again) and
    written, and the index vectors."""
    return 2 * 128 * N + 4 * N * (1 if which in ("copy", "grid") else 2)


def rowgather_plain(which: str, t: dict):
    """The plain PyTorch version of probe `which` on the tensors `t`."""
    from tbz_torch.ops import rowgather as RG
    if which == "rot":
        return RG._rot_rows_plain(t["idx"], t["rot"], t["tbl"])
    if which == "accum":
        return RG._accum_rows_plain(t["idx"], t["dst"], t["tbl"])
    return RG._copy_rows_plain(t["idx"], t["tbl"])


def rowgather_edge_cases(dev, shapes) -> dict:
    """Phase 10's edge cases of copy_rows and grid_rows
    (tests/torch_util.py: ragged N, indices outside the table, idx and
    table views 4 bytes into their storage, idx[::2], at `shapes`), each
    exactly equal to _copy_rows_plain; then all four probes on strided
    index vectors, and on rot_rows' and accum_rows' edge cases
    (torch_util.rowgather_rot_accum_cases at `shapes`), each equal to
    its plain version."""
    from tbz_torch.ops import rowgather as RG
    cases = test_util().rowgather_edge_cases(dev, shapes)
    for name, idx, tbl in cases:
        want = RG._copy_rows_plain(idx, tbl)
        for fn in (RG.copy_rows, RG.grid_rows):
            expect(max_abs_err(fn(idx, tbl), want) == 0,
                   f"{fn.__name__} differs from its plain version ({name})")
    log(f"  copy_rows and grid_rows equal _copy_rows_plain on "
        f"{len(cases)} edge cases: " + "; ".join(n for n, _, _ in cases))
    for N, R in shapes:   # every probe on strided index vectors
        t = test_util().rowgather_strided_inputs(dev, N, R)
        c = {k: v.contiguous() for k, v in t.items()}
        for which in RG.PROBES:
            expect(max_abs_err(RG.call(which, t),
                               rowgather_plain(which, c)) == 0,
                   f"{which}_rows differs on strided index vectors (N={N})")
        del t, c
    log("  all four probes equal their plain versions on strided index "
        "vectors (idx[::2], rot[::2], dst[::2]) at " + ", ".join(
            f"N={N} R={R}" for N, R in shapes))
    more = test_util().rowgather_rot_accum_cases(dev, shapes)
    for name, idx, rot, dst, tbl in more:
        for fn, plain, args in (
                (RG.rot_rows, RG._rot_rows_plain, (idx, rot, tbl)),
                (RG.accum_rows, RG._accum_rows_plain, (idx, dst, tbl)),
                (RG.copy_rows, RG._copy_rows_plain, (idx, tbl)),
                (RG.grid_rows, RG._copy_rows_plain, (idx, tbl))):
            expect(max_abs_err(fn(*args), plain(*args)) == 0,
                   f"{fn.__name__} differs from its plain version ({name})")
    log(f"  all four probes equal their plain versions on {len(more)} "
        "rot/accum edge cases: " + "; ".join(c[0] for c in more))
    return {"cases": [n for n, _, _ in cases] + ["strided vectors"]
            + [c[0] for c in more], "max_abs_err": 0}


def rowgather_probes(dev, shapes, reps: int) -> tuple:
    """Phase 10: the four row-gather probes through their entry point
    (tbz_torch.ops.rowgather.probe, the CLI's: seeded inputs, numpy
    check, CUDA-event times), counts reset just before and read just
    after; then each kernel against its plain version on the same inputs
    (exact), timed beside its plain version and the library call."""
    import torch
    from tbz_torch import _cuda
    from tbz_torch.ops import rowgather as RG
    _cuda.reset_counts()
    probes = {}
    for which in RG.PROBES:
        for N, R in shapes:
            probes[f"{which}/{N}"] = RG.probe(which, N, R, device=dev,
                                              reps=reps)
    counts = _cuda.launch_counts()
    if dev.type == "cuda":
        expect_launched(counts, tuple(ROWGATHER.values()),
                        "the row-gather probes")

    def library(which, t):
        if which == "rot":
            return None         # no single call rotates rows
        if which == "accum":    # two calls into a zeroed output
            return lambda: torch.zeros(
                t["idx"].shape[0], 32, dtype=torch.int32, device=dev
            ).index_add_(0, t["dst"],
                         torch.index_select(t["tbl"], 0, t["idx"]))
        return lambda: torch.index_select(t["tbl"], 0, t["idx"])

    rows, detail = [], {}
    for which, name in ROWGATHER.items():
        per = {}
        for N, R in shapes:
            t = RG.to_tensors(RG.probe_inputs(which, N, R), dev)
            k = RG.call(which, t)
            err = max_abs_err(k, rowgather_plain(which, t))
            expect(err == 0, f"{name} at N={N}: differs from its plain "
                   "version")
            del k
            lib = library(which, t)
            per[N] = {"R": R, "max_abs_err": err,
                      "ms": timed(lambda: RG.call(which, t), dev, reps),
                      "plain_ms": timed(lambda: rowgather_plain(which, t),
                                        dev, 1),
                      "library_ms": timed(lib, dev, reps) if lib else None,
                      "bound_ms": bound_ms(rowgather_bytes(which, t)),
                      "gather_bound_ms": bound_ms(gather_bytes(which, N)),
                      "probe": probes[f"{which}/{N}"]}
            per[N]["Mrows_s"] = N / per[N]["ms"] / 1e3
            lib_s = ("null" if lib is None else
                     f"{per[N]['library_ms']:.4f} ms"
                     + (" (2 calls)" if which == "accum" else ""))
            log(f"  {name} N={N} R={R}: kernel {per[N]['ms']:.4f} ms "
                f"({per[N]['Mrows_s']:.1f} M rows/s), probe "
                f"{per[N]['probe']['ms']:.4f} ms, bound "
                f"{per[N]['bound_ms']:.4f} ms (gather_bound_ms "
                f"{per[N]['gather_bound_ms']:.4f}), plain "
                f"{per[N]['plain_ms']:.3f} ms, library {lib_s}, "
                f"max_abs_err {err}")
            del t
        detail[name] = per
        big = per[max(per)]
        rows.append({"name": name, "route": "cuda",
                     "source": "tbz_torch/csrc/rowgather.cu",
                     "replaces": {
                         "copy": "scripts/pallas_spike_r3.py:39",
                         "rot": "scripts/pallas_spike_r3.py:47",
                         "accum": "scripts/pallas_spike_r3.py:59",
                         "grid": "scripts/pallas_spike_r3.py:179"}[which],
                     "launches": 0,
                     "max_abs_err": max(v["max_abs_err"]
                                        for v in per.values()),
                     "ms": big["ms"], "plain_ms": big["plain_ms"],
                     "bound_ms": big["bound_ms"], "bound_by": "bytes",
                     "library_ms": big["library_ms"]})
    detail["edge_cases"] = rowgather_edge_cases(dev, shapes)
    return rows, detail, counts


FUSED_KERNELS = PATH_KERNELS[:5]   # the fused decode's


def counted(dev, what: str, fn, need=FUSED_KERNELS) -> tuple:
    """(fn(), ms, counts): every count set to 0 just before, read just
    after; host clock around the call, which ends in a synchronize. On a
    card, each kernel of `need` must have launched (its counts logged)."""
    from tbz_torch import _cuda
    sync(dev)
    _cuda.reset_counts()
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    counts = _cuda.launch_counts()
    if dev.type == "cuda" and need:
        expect_launched(counts, need, what)
    return out, ms, counts


def host_timed(dev, fn) -> tuple:
    """(fn(), ms) for a host call, by the host clock after a
    synchronize."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def public_surface(dev, streams: list, batch: tuple,
                   decompress_ms: float, l9_size: int) -> tuple:
    """Phase 11: the rest of the public calls at full size, each output
    byte-identical to stdlib zlib / gzip / zipfile. Returns (results,
    the launch counts summed over its decodes)."""
    import io
    import tempfile
    import zipfile
    import tbz_torch
    dkw = {} if dev.type == "cuda" else {"device": dev}
    res, total = {}, {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    big_name, big_gz, _, d_big = streams[-1]
    log("  (a) compress, then decompress on the card")
    for level, size, threads in ((1, len(d_big), 4), (6, len(d_big), 4),
                                 (9, l9_size, None)):
        data = d_big[:size]
        c, ms = host_timed(dev, lambda: tbz_torch.compress(
            data, "zlib", level, threads=threads))
        ref, zms = host_timed(dev, lambda: zlib.compress(data, level))
        expect(len(c) <= len(ref),
               f"compress L{level} of {size} B: {len(c)} B, "
               f"{len(c) - len(ref)} B over zlib's {len(ref)} B")
        out, dms, counts = counted(
            dev, f"the decode of compress L{level}",
            lambda: tbz_torch.decompress(c, **dkw))
        add(counts)
        expect(out == data and zlib.decompress(c) == data,
               f"compress L{level}: round trip differs from the input")
        res[f"compress_L{level}"] = {
            "in_bytes": size, "out_bytes": len(c), "zlib_bytes": len(ref),
            "threads": threads, "ms": ms, "MBps": size / ms / 1e3,
            "zlib_ms": zms, "decode_ms": dms}
        log(f"  compress L{level} of {size} B (threads={threads}): "
            f"{len(c)} B (zlib {len(ref)} B, {len(c) - len(ref)}), "
            f"{ms:.1f} ms = {size / ms / 1e3:.1f} MB/s (zlib {zms:.1f} ms);"
            f" decompress on {dev} {dms:.1f} ms, byte-identical")

    log(f"  (b) decompress_file of {big_name}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "big.gz")
        with open(path, "wb") as f:
            f.write(big_gz)
        for kw in ({}, {"device_resident": True}):
            need = FUSED_KERNELS + (("crc32",) if kw else ())

            def call():
                return tbz_torch.decompress_file(path, **kw, **dkw)
            out, ms, counts = counted(dev, f"decompress_file {kw}", call,
                                      need)
            add(counts)
            if kw:
                expect(out.device.type == dev.type, "not on the device")
                out = out.cpu().numpy().tobytes()
            expect(out == d_big, f"decompress_file {kw}: differs from gzip")
            times = [ms] + [counted(dev, "", call, ())[1] for _ in range(2)]
            med = sorted(times)[1]
            key = "decompress_file" + ("_resident" if kw else "")
            res[key] = {"median_ms": med, "runs_ms": times,
                        "decompress_median_ms": decompress_ms}
            log(f"  decompress_file{' device_resident' * bool(kw)}: median "
                f"of 3 {med:.1f} ms ({', '.join(f'{t:.1f}' for t in times)})"
                f", byte-identical; phase 3 decompress of the same bytes, "
                f"median of 3: {decompress_ms:.1f} ms")

        log("  (c) decompress_into")
        for name, payload, _, want in (streams[1], streams[2]):
            buf = bytearray(len(want) + 64)
            n, ms = host_timed(
                dev, lambda: tbz_torch.decompress_into(payload, buf))
            expect(n == len(want) and buf[:n] == want,
                   f"decompress_into {name}: differs from zlib/gzip")
            res[f"decompress_into_{name}"] = {"ms": ms}
            log(f"  decompress_into {name}: {n} B, {ms:.2f} ms, "
                "byte-identical")

        log("  (d) decompress_stream and a Decompressor")
        with open(path, "rb") as f:
            parts, ms = host_timed(dev, lambda: list(
                tbz_torch.decompress_stream(f, chunk_size=MIB)))
        expect(b"".join(parts) == d_big, "decompress_stream differs")
        res["decompress_stream"] = {"ms": ms, "chunks": len(parts)}
        log(f"  decompress_stream of {big_name} in 1 MiB chunks: "
            f"{len(parts)} output pieces, {ms:.1f} ms, byte-identical")
    name, payload, _, want = streams[1]
    for chunk in (1, 7, 65536):
        def feed():
            d, out, mid = tbz_torch.Decompressor(), [], len(payload) // 2
            for i in range(0, len(payload), chunk):
                out.append(d.decompress(payload[i:i + chunk]))
                if i <= mid < i + chunk:
                    d = tbz_torch.Decompressor.restore(d.checkpoint())
            out.append(d.flush())
            return b"".join(out), d.eof
        (out, eof), ms = host_timed(dev, feed)
        expect(out == want and eof, f"Decompressor in {chunk} B chunks "
               "with a checkpoint: differs from zlib")
        res[f"decompressor_{chunk}B"] = {"ms": ms}
        log(f"  Decompressor on {name} in {chunk} B chunks, restored from a "
            f"checkpoint half way: {ms:.1f} ms, byte-identical")

    names, _, datas = batch
    log(f"  (e) ZipWriter / ZipReader, {len(names)} Silesia-sized members")
    w = tbz_torch.ZipWriter()
    _, ms = host_timed(dev, lambda: [w.write(n, d, level=6)
                                for n, d in zip(names, datas)])
    blob = w.getvalue()
    zf = zipfile.ZipFile(io.BytesIO(blob))
    expect(zf.testzip() is None and all(
        zf.read(n) == d for n, d in zip(names, datas)),
        "zipfile reads other bytes from ZipWriter's archive")
    total_in = sum(len(d) for d in datas)
    res["zip_write"] = {"ms": ms, "in_bytes": total_in,
                        "out_bytes": len(blob), "MBps": total_in / ms / 1e3}
    log(f"  ZipWriter L6: {total_in} B -> {len(blob)} B, {ms:.1f} ms "
        f"({total_in / ms / 1e3:.1f} MB/s); zipfile reads every member")
    r = tbz_torch.ZipReader(blob, **dkw)
    read_ms = 0.0
    for e, d in zip(r.infolist(), datas):
        need = FUSED_KERNELS if e.compressed_size >= 65536 else ()
        out, ms, counts = counted(dev, f"ZipReader.read {e.name}",
                                  lambda: r.read(e.name), need)
        add(counts)
        expect(e.method == 8 and out == d,
               f"ZipReader.read {e.name}: differs from zipfile")
        read_ms += ms
    res["zip_read"] = {"ms": read_ms}
    log(f"  ZipReader.read of each member on {dev}: {read_ms:.1f} ms in "
        "all, byte-identical, the fused kernels launched for each")
    want = dict(zip(names, datas))
    out, ms, counts = counted(dev, "ZipReader.read_all", r.read_all)
    add(counts)
    expect(out == want, "ZipReader.read_all differs from zipfile")
    host = tbz_torch.ZipReader(blob, backend="host")
    hout, hms, hcounts = counted(dev, "read_all on the host", host.read_all,
                                 ())
    expect(hout == want and not any(hcounts.values()),
           "read_all on the host: other bytes, or a kernel launched")
    res["zip_read_all"] = {"ms": ms, "host_ms": hms}
    log(f"  ZipReader.read_all: {ms:.1f} ms on {dev}, {hms:.1f} ms with "
        "backend='host' (no kernel launched), both byte-identical")
    return res, total


def run(dev, big: int = 64 * MIB, small: int = MIB, reps: int = 10,
        large: int = 640 * MIB, scale: float = 1.0,
        small_max: int = 63 << 10, spec_big: int = 64 * MIB,
        group_shard: int = 16 * MIB,
        probe_shapes=((8192, 4096), (1 << 22, 1 << 20)),
        l9_size: int = 8 * MIB) -> dict:
    t_run = time.perf_counter()
    log("== phase 1: build")
    b = build(dev)
    log(f"build: kernels {b['kernels_s']} s, native {b['native_s']:.1f} s, "
        f"wall {b['total_s']:.1f} s")
    log("== phase 2: kernels against their plain versions")
    rows = check_kernels(dev, small, reps, small_max)
    log("== phase 3: main path")
    streams = main_streams(big, small)
    mp = main_path(dev, streams, big)
    log("== phase 4: error classes")
    error_classes(dev)
    log("== phase 5: device-resident decode")
    rp = resident_path(dev, streams,
                       mp["streams"][streams[-1][0]]["e2e_median_ms"])
    log(f"== phase 6: checksums of {large} bytes")
    lc, buf, host = large_checksums(dev, large)
    log("== phase 7: batched member decode, Silesia-shaped")
    batch = silesia_batch(scale)
    bp, batch_outs = batched_path(dev, batch)
    log("== phase 8: the declined-stream route, both frontends")
    d_big = streams[-1][3]
    fixed_gz = fixed_deflate(d_big, 31)
    dr = declined_route(dev, d_big, fixed_gz, small_max, spec_big)
    log(f"== phase 8c: flat span resolve against pointer doubling, "
        f"{big // MIB} MiB static-only tape")
    dr["flat_vs_core"] = flat_vs_core(dev, fixed_gz[10:-8], d_big)
    log("== phase 8d: error classes through the device frontend")
    declined_errors(dev)
    log("== phase 8e: the declined route's kernels at 63 KB and 64 MiB")
    dr["kernel_times"] = declined_kernel_times(dev, d_big, fixed_gz[10:-8],
                                               dr["flat_vs_core"])
    log(f"== phase 9a: sequence-sharded CRC-32/Adler-32 of {large} bytes "
        "over a mesh of 4")
    sc, sc_counts = sharded_checksums(dev, buf, host)
    del buf, host
    log("== phase 9b: a process group of one process per local card")
    pg = process_group(dev, group_shard)
    log("== phase 9c: the Silesia-shaped batch over a mesh")
    md, md_counts = mesh_decode(dev, batch, batch_outs,
                                bp["e2e_median_ms"])
    del batch_outs
    log("== phase 10: the row-gather probes")
    rg_rows, rg, rg_counts = rowgather_probes(dev, probe_shapes, reps)
    rows += rg_rows
    log("== phase 10b: the flat resolve through tbz's scan and gscat "
        "layouts")
    d_small = corpus(SEED, small)
    rg["flat_layouts"] = flat_layouts(
        dev, zlib.compress(d_small, 6)[2:-4], d_small, 5)
    log("== phase 11: the public surface")
    t11 = time.perf_counter()
    ps, ps_counts = public_surface(
        dev, streams, batch, mp["streams"][streams[-1][0]]["e2e_median_ms"],
        l9_size)
    del batch
    ps["wall_s"] = time.perf_counter() - t11
    log(f"phase 11 wall {ps['wall_s']:.1f} s")
    counts = {"main_path": mp["counts"], "device_resident": rp["counts"],
              "batched_members": bp["counts"],
              "declined_auto": dr["counts"]["auto"],
              "declined_device": dr["counts"]["device"],
              "sharded_checksums": sc_counts,
              **{f"mesh_decode ({k})": v for k, v in md_counts.items()},
              "rowgather_probes": rg_counts, "public_surface": ps_counts}
    for r in rows:
        r["launches"] = sum(c[r["name"]] for c in counts.values())
        if r["name"] == "resolve_batch":   # and at every Silesia bucket
            r["max_abs_err"] = max([r["max_abs_err"]] + [
                b["max_abs_err"] for b in bp["buckets"]])
    wall = time.perf_counter() - t_run
    log(f"run wall {wall:.1f} s, phase 11's {ps['wall_s']:.1f} s of it")
    return {"build": b, "kernels": rows, "main_path": mp["streams"],
            "device_resident": rp["streams"], "large_checksums": lc,
            "batched_members": bp, "declined_route": dr,
            "sharded_checksums": sc, "process_group": pg,
            "mesh_decode": md, "rowgather": rg, "public_surface": ps,
            "launch_counts": counts, "wall_s": wall}


def main(argv: list[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for chip_smoke.json")
    ap.add_argument("--mesh-worker", nargs=5, metavar=(
        "RANK", "WORLD", "PORT", "DEVICE_TYPE", "SHARD_BYTES"),
        help="run one process of phase 9b's group (started by phase 9b)")
    args = ap.parse_args(argv)
    out_dir = args.out
    if args.mesh_worker:
        r, w, port, dt, sb = args.mesh_worker
        return mesh_worker(int(r), int(w), int(port), dt, int(sb))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import tbz_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: tbz_torch not importable ({e}); run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    log(f"card: {smi}")
    dev = torch.device("cuda", 0)
    try:
        res = run(dev)
    except Exception as e:  # every phase's failure ends the run
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump(dict(res, card=smi), f, indent=1)
    print(json.dumps({"kernels": res["kernels"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
