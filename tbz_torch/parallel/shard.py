"""Sharded decode, the port of tbz/parallel/shard.py: data-parallel
streams and sequence-parallel checksums over a mesh (parallel/mesh.py).

Independent streams (BASELINE config 5's shape: gzip members, deflate
streams): host tokenizers (native, a thread pool) parse every member, a
payload's members one after another, except a BGZF payload's, which
BSIZE cuts apart from the headers alone so that they are tokenized in
parallel; members are grouped into power-of-two size buckets (tape
length, output capacity, the member's own input length) so one huge
stream does not pad the small ones; each bucket's rows are cut into
contiguous blocks over the mesh's 'dp' axis, as tbz's P("dp") places
them, and each device resolves its block (kernel 7, one row a member,
at most MAX_ROWS rows a launch) and checksums it (kernels 5 and 6, only
the kinds its framing needs); outputs come back in stream order. The
call is the stage `decode.batch`, cut into the spans batch.split,
.tokenize, .stage, .upload, .resolve, .verify and .fetch (_Spans).

One long stream's checksum can instead be sequence-sharded: each device
checksums its own byte range (kernels 5 and 6), the (value, length)
partials meet on one device (a copy in one process, a torch.distributed
all_gather across processes), and a tree of the combine kernel folds
them in order.

Unlike tbz, a device failure is not retried on the host: a kernel or
launch failure raises, and only a DeflateError (a corrupt stream) turns
into that stream's error value.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import os

import numpy as np
import torch

from .. import _cuda
from .. import checksums as cs
from .. import frontend
from ..errors import DeflateError, ERR_HEADER, TruncatedError
from ..formats import gzip_fmt, zlib_fmt
from ..ops import resolve as R
from ..ops.resolve import _resolve_batch
from ..tape import TokenTape
from ..utils import profiling as P
from .mesh import make_mesh, process_rank

W = R.W
# tbz's shard alignment: its CRC folds 128-byte lanes, its Adler
# 4096-byte chunks (tbz/checksums.py CRC_LANE_BYTES, ADLER_CHUNK)
CRC_LANE_BYTES = 128
ADLER_CHUNK = 4096
# rows a launch takes at most: K7 (csrc/resolve.cu) and K5/K6
# (csrc/crc32.cu, csrc/adler32.cu) give each row a blockIdx.y, which CUDA
# caps at 65,535
MAX_ROWS = 65535

# the batched checksums of tbz/parallel/shard.py:46/53 (CRC from 0,
# Adler from 1, over rows[s, :lens[s]])
_crc_batch = cs.crc32_device_tail_batch
_adler_batch = cs.adler32_device_tail_batch


def _pow2(n, floor):
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


def _finished(res):
    if not res.finished:
        raise TruncatedError("member body truncated")
    return res


def _own_tape(res):
    """`res` with its tape copied to its own length: the tokenizer sizes
    the tape's arrays by the input it was given, here the rest of the
    payload."""
    t = res.tape
    res.tape = TokenTape(out_len=t.out_len.copy(), dist=t.dist.copy(),
                         root_val=t.root_val.copy(), total_out=t.total_out)
    return res


def _bsize(hdr) -> int | None:
    """The BSIZE of a gzip member's BGZF subfield `BC` (SAMv1 §4.1: SI1
    66, SI2 67, SLEN 2; the member's size in bytes less 1), or None where
    its header holds none."""
    for sid, value in hdr.subfields():
        if sid == b"BC" and len(value) == 2:
            return int.from_bytes(value, "little")
    return None


def _tokenize_members(payload: bytes, format: str):
    """Host frontend for one payload: parse EVERY member in order
    (multi-member gzip supported). Returns a list of member dicts; a
    member's `body` is a view of its own deflate bytes. Format "bgzf" is
    gzip whose every member carries the BGZF `BC` subfield."""
    from .. import api

    payload = bytes(payload)
    fmt = api.detect_format(payload) if format == "auto" else format
    members = []
    pos = 0
    while True:
        if fmt in ("gzip", "bgzf"):
            hdr = gzip_fmt.parse_header(payload, pos)
            if fmt == "bgzf" and _bsize(hdr) is None:
                raise DeflateError("gzip member without the BGZF BC "
                                   "subfield", ERR_HEADER)
            rest = memoryview(payload)[hdr.data_offset:]
            res = _finished(frontend.tokenize(rest))
            end = (res.end_bit + 7) // 8
            crc, isize = gzip_fmt.read_trailer(rest, end)
            if len(rest) > end + 8:
                res = _own_tape(res)
            members.append(dict(fmt=fmt, body=rest[:end], res=res,
                                kind="crc32", expect=crc, isize=isize))
            pos = hdr.data_offset + end + 8
            if pos + 2 > len(payload) or payload[pos:pos + 2] != b"\x1f\x8b":
                # Bytes after a complete member that don't start another
                # member are benign trailing garbage — the same policy as
                # api.decompress (unused_data) and zlib.decompressobj(31).
                break
        elif fmt == "zlib":
            hdr = zlib_fmt.parse_header(payload)
            rest = memoryview(payload)[hdr.data_offset:]
            res = _finished(frontend.tokenize(rest))
            data_end = (res.end_bit + 7) // 8
            adler = zlib_fmt.read_trailer(rest, data_end)
            # bytes past the adler trailer: benign unused_data, matching
            # api.decompress (zlib.decompressobj semantics)
            members.append(dict(fmt=fmt, body=rest[:data_end], res=res,
                                kind="adler32", expect=adler, isize=None))
            break
        else:
            res = _finished(frontend.tokenize(payload))
            members.append(dict(fmt=fmt,
                                body=memoryview(payload)[:(res.end_bit + 7)
                                                         // 8],
                                res=res, kind=None, expect=None, isize=None))
            break
    return members


def _bgzf_extents(payload: bytes) -> list | None:
    """Each member's (body start, end) of a BGZF payload, read from the
    headers alone: a member ends BSIZE + 1 bytes after its start. None
    where a header holds no `BC` or does not parse: the in-order parse
    then decides. Stops where tbz's in-order parse stops, before bytes
    that do not start another member."""
    out, pos = [], 0
    try:
        while True:
            hdr = gzip_fmt.parse_header(payload, pos)
            bsize = _bsize(hdr)
            if bsize is None:
                return None
            end = pos + bsize + 1
            if end - 8 < hdr.data_offset or end > len(payload):
                return None
            out.append((hdr.data_offset, end))
            pos = end
            if pos + 2 > len(payload) or payload[pos:pos + 2] != b"\x1f\x8b":
                return out
    except DeflateError:
        return None


def _tape_arena(extents, pin: bool) -> list:
    """One int32 array of three rows for the tapes of a BGZF payload's
    members, a slice each of the tokenizer's own first size, max(1024,
    body bytes); with `pin`, page-locked memory that torch's caching host
    allocator keeps from call to call, so that the tokenizers write into
    pages already mapped instead of faulting fresh ones in (which one
    process does one at a time). Returns each member's (out_len, dist,
    root_val) slices."""
    caps = [max(1024, e - 8 - a) for a, e in extents]
    arena = _host_empty((3, sum(caps)), torch.int32, pin)
    at = np.concatenate(([0], np.cumsum(caps)))
    return [tuple(arena[:, a:b]) for a, b in zip(at[:-1], at[1:])]


def _bgzf_member(payload: bytes, start: int, end: int, tape=None):
    """The member whose body is payload[start:end - 8], cut by BSIZE, its
    tape written into `tape` first (_tape_arena); None where its deflate
    stream does not end exactly at its 8-byte trailer (BSIZE lies, or
    the body is corrupt): the in-order parse then gives the payload's
    output or its first error."""
    body = memoryview(payload)[start:end - 8]
    try:
        res = frontend.tokenize(body, into=tape)
    except DeflateError:
        return None
    if not res.finished or (res.end_bit + 7) // 8 != len(body):
        return None
    crc, isize = gzip_fmt.read_trailer(payload, end - 8)
    return dict(fmt="bgzf", body=body, res=res, kind="crc32", expect=crc,
                isize=isize)


def _front(payloads, format: str, pool, spans, tasks: int = 1,
           pin: bool = False) -> list:
    """Every payload's members, or the DeflateError of its parse. A BGZF
    payload (format "bgzf", or a gzip payload whose first member carries
    `BC`) is split by BSIZE and its members tokenized in the pool, into
    one tape arena (_tape_arena; `pin` as there), in `tasks` runs of
    members at most; any disagreement sends it to the in-order parse.
    Other payloads are parsed in order, one task a payload."""
    from .. import api

    def in_order(p):
        try:
            return _tokenize_members(p, format)
        except DeflateError as e:
            return e

    def run(p, ext, tapes):
        return [_bgzf_member(p, a, e, t) for (a, e), t in zip(ext, tapes)]

    with spans("split", sum(len(p) for p in payloads)):
        plans = []
        for p in payloads:
            p = bytes(p)
            fmt = api.detect_format(p) if format == "auto" else format
            ext = _bgzf_extents(p) if fmt in ("gzip", "bgzf") else None
            plans.append((p, ext, _tape_arena(ext, pin) if ext else None))
    with spans("tokenize", sum(len(p) for p, _, _ in plans)):
        jobs = []
        for p, ext, tapes in plans:
            if ext is None:
                jobs.append(pool.submit(in_order, p))
                continue
            k = -(-len(ext) // tasks)
            jobs.append([pool.submit(run, p, ext[i:i + k], tapes[i:i + k])
                         for i in range(0, len(ext), k)])
        per_stream = []
        for (p, ext, _), job in zip(plans, jobs):
            if ext is None:
                per_stream.append(job.result())
                continue
            members = [m for f in job for m in f.result()]
            if all(m is not None for m in members):
                spans.stats["bgzf_members"] += len(members)
                per_stream.append(members)
            else:
                spans.stats["fallbacks"] += 1
                per_stream.append(in_order(p))
    return per_stream


def _bucket_key(mem) -> tuple:
    t = mem["res"].tape
    return (_pow2(len(t), 1024), _pow2(t.total_out, 4096),
            _pow2(len(mem["body"]), 1024))


def _host_empty(shape, dtype: torch.dtype, pin: bool) -> np.ndarray:
    """An uninitialised host array; with `pin`, in page-locked memory from
    torch's caching host allocator, whose blocks later calls take again
    (no fresh pages to fault in) and which a card copies from directly."""
    return torch.empty(shape, dtype=dtype, pin_memory=pin).numpy()


# rows a task of _stage_bucket fills
_STAGE_RUN = 32


def _stage_bucket(its, T: int, M: int, pool, pin: bool = False):
    """Host arrays of one bucket: tapes int32[S, T], counts, inputs
    uint8[S, M] (rows filled in parallel, _STAGE_RUN a task; large numpy
    copies release the GIL; `pin`: the tapes and inputs in page-locked
    memory, for a card).
    Returns (out_len, dist, root_val, n_tokens, total_out, inputs)."""
    S = len(its)
    out_len = _host_empty((S, T), torch.int32, pin)
    dist = _host_empty((S, T), torch.int32, pin)
    root_val = _host_empty((S, T), torch.int32, pin)
    n_tokens = np.zeros(S, np.int32)
    total_out = np.zeros(S, np.int64)
    inputs = _host_empty((S, M), torch.uint8, pin)

    def row(i):
        mem = its[i][2]
        t = mem["res"].tape
        n = len(t)
        for dst, src in ((out_len, t.out_len), (dist, t.dist),
                         (root_val, t.root_val)):
            dst[i, :n] = src
            dst[i, n:] = 0
        n_tokens[i] = n
        total_out[i] = t.total_out
        body = mem["body"]
        inputs[i, :len(body)] = np.frombuffer(body, np.uint8)
        inputs[i, len(body):] = 0

    def run(lo):
        for i in range(lo, min(lo + _STAGE_RUN, S)):
            row(i)

    list(pool.map(run, range(0, S, _STAGE_RUN)))
    return out_len, dist, root_val, n_tokens, total_out, inputs


def _upload(arrays, device):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _on(dev):
    """Make `dev` the current card while its kernels launch."""
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


def _row_blocks(mesh, S: int) -> list:
    """The 'dp' blocks of a bucket of S rows: [(device, lo, hi, rank)].
    As tbz pads a bucket to a multiple of the mesh's size (:214) and
    P("dp") cuts it into dp equal blocks; the pad rows hold no member and
    are not staged. A block lives on the first entry of its mesh row
    (the 'sp' replicas hold the same rows)."""
    dp = mesh.shape["dp"]
    b = -(-S // mesh.size) * mesh.size // dp
    return [(mesh.devices[d, 0], min(d * b, S), min((d + 1) * b, S),
             int(mesh.ranks[d, 0])) for d in range(dp)]


class _Spans:
    """The batch route's spans inside `decode.batch`, each a
    utils.profiling.stage named batch.<name>, and its counters. `stats`
    is collect_stats' dict: the counters, and each span's ms summed
    (timed only under collect_stats or Config.profile)."""

    COUNTS = ("members", "bgzf_members", "fallbacks", "buckets", "launches",
              "onchip_rows", "staged_bytes", "used_bytes")
    NAMES = ("split", "tokenize", "stage", "upload", "resolve", "verify",
             "fetch")

    def __init__(self, timed: bool = False):
        self.timed = timed
        self.stats = dict.fromkeys(self.COUNTS, 0)
        self.stats.update((f"{n}_ms", 0.0) for n in self.NAMES)

    @contextlib.contextmanager
    def __call__(self, name: str, nbytes: int = 0, device=None):
        with P.stage(f"batch.{name}", nbytes, device, self.timed) as sp:
            yield
        self.stats[f"{name}_ms"] += sp.ms


def _resolve_batch_on_mesh(mesh, staged, cap: int, spans=None) -> list:
    """Resolve a bucket's staged host arrays (out_len, dist, root_val,
    n_tokens, total_out, inputs; S rows each) block by block on the mesh,
    each block in launches of at most MAX_ROWS rows (spans `batch.upload`
    and `batch.resolve` each; the rows of a launch that K7 reports on its
    on-chip path, the launch count resolve_onchip, count as
    `onchip_rows`). Returns [(lo, hi, bodies)] for the launches of the
    blocks this process owns: bodies uint8[hi - lo, cap]
    on the block's device hold rows lo..hi-1, each row's output in
    [0, total_out). The counterpart of the `out.addressable_shards` of
    tbz's sharded _resolve_batch."""
    ol, di, rv, nt, tot, inp = staged
    spans = spans or _Spans()
    me = process_rank()
    out = []
    for dev, lo, hi, rank in _row_blocks(mesh, len(nt)):
        if rank != me:
            continue
        for a in range(lo, hi, MAX_ROWS):
            b = min(a + MAX_ROWS, hi)
            rows = (ol[a:b], di[a:b], rv[a:b], nt[a:b], inp[a:b])
            with _on(dev):
                with spans("upload", sum(x.nbytes for x in rows), dev):
                    tapes = _upload(rows, dev)
                with spans("resolve", int(tot[a:b].sum()), dev):
                    win = torch.zeros(b - a, W, dtype=torch.uint8,
                                      device=dev)
                    onchip = _cuda.launch_counts()["resolve_onchip"]
                    bodies, _ = _resolve_batch(*tapes[:4], tot[a:b],
                                               tapes[4], win, cap)
                    if _cuda.launch_counts()["resolve_onchip"] > onchip:
                        spans.stats["onchip_rows"] += b - a
            spans.stats["launches"] += 1
            out.append((a, b, bodies))
    return out


def decode_streams_sharded(payloads: list[bytes], mesh=None,
                           format: str = "auto", verify: bool = True,
                           return_errors: bool = False,
                           device_resident: bool = False,
                           collect_stats: bool = False):
    """Decode independent raw/zlib/gzip/BGZF streams data-parallel over
    the mesh's 'dp' axis (default: a mesh over every local CUDA card; a
    CPU mesh, make_mesh(devices=["cpu"] * k), runs the plain versions).
    Returns a list of per-stream outputs (bytes), in stream order. With
    return_errors=True, a corrupt stream yields its exception object at
    its position instead of aborting the batch; otherwise the first error
    is raised after all healthy streams were decoded.

    format "bgzf" (SAMv1 §4.1: gzip members of at most 64 KiB, each with
    the BSIZE subfield `BC`) requires `BC` on every member; "auto" and
    "gzip" take a gzip payload whose first member carries it as BGZF too.
    A BGZF payload is split by BSIZE and its members tokenized in
    parallel; the output and the first error are those of the in-order
    parse.

    device_resident=True keeps decoded bytes on the devices: each
    stream's entry is a list of (uint8 row tensor, length) members
    (consumers slice row[:length]); only the checksum values cross to
    the host.

    collect_stats=True returns (outputs, stats): the spans' ms (`*_ms`,
    each batch.* span timed, a device span ending in a synchronize) and
    the counters of _Spans.COUNTS (members, those split by BSIZE,
    payloads sent back to the in-order parse, buckets, K7 launches, the
    rows K7 resolved on one SM (0 on a CPU mesh), staged host bytes
    against the tape and body bytes they hold). Under Config.profile the spans time into
    utils.profiling.metrics, nested in `decode.batch`, and the counters
    add to its report.

    A mesh that spans processes raises ValueError: this process cannot
    fetch another's rows (run _resolve_batch_on_mesh on each process).
    """
    if mesh is None:
        mesh = make_mesh(sp=1)
    if not mesh.is_local():
        raise ValueError("decode_streams_sharded needs a mesh of this "
                         "process's devices")
    n_threads = min(32, max(4, os.cpu_count() or 4))
    on_card = any(d.type == "cuda" for d in mesh.devices.flat)
    spans = _Spans(collect_stats)
    stats = spans.stats

    with P.stage("decode.batch", sum(len(p) for p in payloads)), \
            concurrent.futures.ThreadPoolExecutor(n_threads) as pool:
        per_stream = _front(payloads, format, pool, spans,
                            tasks=4 * n_threads, pin=on_card)

        member_out: dict = {}
        member_err: dict = {}
        with spans("stage"):
            buckets: dict = {}
            for si, m in enumerate(per_stream):
                if isinstance(m, Exception):
                    continue
                for mi, mem in enumerate(m):
                    buckets.setdefault(_bucket_key(mem), []).append(
                        (si, mi, mem))
            stats["buckets"] += len(buckets)
        for (T, cap, M), its in buckets.items():
            with spans("stage", len(its) * (12 * T + M)):
                staged = _stage_bucket(its, T, M, pool, pin=on_card)
            total_out = staged[4]
            stats["members"] += len(its)
            stats["staged_bytes"] += len(its) * (12 * T + M)
            stats["used_bytes"] += sum(12 * len(mem["res"].tape)
                                       + len(mem["body"])
                                       for _, _, mem in its)
            for lo, hi, bodies in _resolve_batch_on_mesh(mesh, staged, cap,
                                                         spans):
                kinds = {mem["kind"] for _, _, mem in its[lo:hi]}
                nbytes = int(total_out[lo:hi].sum())
                with spans("verify", nbytes, bodies.device):
                    with _on(bodies.device):
                        crcs = (_crc_batch(bodies, total_out[lo:hi]).cpu()
                                .numpy() if verify and "crc32" in kinds
                                else None)
                        adlers = (_adler_batch(bodies, total_out[lo:hi])
                                  .cpu().numpy()
                                  if verify and "adler32" in kinds else None)
                    for i in range(hi - lo):
                        si, mi, mem = its[lo + i]
                        n = int(total_out[lo + i])
                        try:
                            if verify and mem["kind"] == "crc32":
                                gzip_fmt.check_trailer(mem["expect"],
                                                       int(crcs[i]),
                                                       mem["isize"], n)
                            elif verify and mem["kind"] == "adler32":
                                zlib_fmt.check_adler(mem["expect"],
                                                     int(adlers[i]))
                        except DeflateError as e:
                            member_err[si] = e
                with spans("fetch", nbytes):
                    # one D2H a launch's rows (page-locked from a card); a
                    # member's output is a view of its row until the join
                    host = None if device_resident else torch.empty(
                        bodies.shape, dtype=torch.uint8,
                        pin_memory=bodies.is_cuda).copy_(bodies).numpy()
                    for i in range(hi - lo):
                        si, mi, _ = its[lo + i]
                        n = int(total_out[lo + i])
                        member_out[(si, mi)] = (
                            (bodies[i], n) if device_resident
                            else host[i, :n])

        with spans("fetch"):
            outputs: list = []
            first_error = None
            for si, m in enumerate(per_stream):
                err = m if isinstance(m, Exception) else member_err.get(si)
                if err is not None:
                    outputs.append(err)
                    first_error = first_error or err
                elif device_resident:
                    outputs.append([member_out[(si, mi)]
                                    for mi in range(len(m))])
                else:
                    outputs.append(b"".join(member_out[(si, mi)]
                                            for mi in range(len(m))))
    P.count({k: stats[k] for k in _Spans.COUNTS})
    if first_error is not None and not return_errors:
        raise first_error
    return (outputs, stats) if collect_stats else outputs


# --- sequence-parallel checksums (one stream sharded over devices) ---------

_EMPTY = {"crc32": 0, "adler32": 1}   # the checksum of no bytes


def _fold(kind: str, vals, lens):
    """Fold partials in order: vals int64[k] checksums of consecutive
    ranges of lens int64[k] bytes, on one device. A tree of the combine
    kernel, one launch a level (ceil(log2 k) levels); a level's odd last
    partial passes through. Returns the int64 0-d checksum of it all."""
    while vals.shape[0] > 1:
        h = vals.shape[0] // 2
        out = cs._combine(kind, torch.stack(
            [vals[0:2 * h:2], vals[1:2 * h:2], lens[1:2 * h:2]]))
        vals = torch.cat([out, vals[2 * h:]])
        lens = torch.cat([lens[0:2 * h:2] + lens[1:2 * h:2], lens[2 * h:]])
    return vals[0]


def _to(a, dev):
    """A 1-D uint8 array or tensor as a tensor on `dev`."""
    if not isinstance(a, torch.Tensor):
        a = np.ascontiguousarray(a, np.uint8)
        a = torch.from_numpy(a if a.flags.writeable else a.copy())
    if a.dtype != torch.uint8 or a.dim() != 1:
        raise ValueError("sharded checksum input must be 1-D uint8")
    return a.to(dev)


def _make_sharded(kind: str, mesh, n_total_padded: int, axis: str,
                  align: int):
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not one of {mesh.axis_names}")
    ndev = mesh.shape[axis]
    if n_total_padded <= 0 or n_total_padded % (ndev * align):
        raise ValueError(f"n_total_padded={n_total_padded} must be a "
                         f"positive multiple of {ndev} x {align}")
    C = n_total_padded // ndev
    a = mesh.axis_names.index(axis)
    me = process_rank()
    shape = mesh.devices.shape
    local = [p for p in np.ndindex(shape) if mesh.ranks[p] == me]
    # shard r's primary replica: index 0 along the other axis
    primary = [(r, (r, 0) if a == 0 else (0, r)) for r in range(ndev)]
    mine = [(r, p) for r, p in primary if mesh.ranks[p] == me]
    if not local:
        raise ValueError("this process owns no entry of the mesh")
    home = mesh.devices[local[0]]   # where the partials meet and fold

    def shards(x):
        """This process's primary shards: {r: uint8[C] on its device}."""
        if isinstance(x, (list, tuple)):
            if len(x) != len(local):
                raise ValueError(f"expected {len(local)} local shards, one "
                                 "per local mesh entry in mesh order")
            byp = dict(zip(local, x))
            out = {r: _to(byp[p], mesh.devices[p]) for r, p in mine}
        else:
            if tuple(x.shape) != (n_total_padded,):
                raise ValueError(f"expected {n_total_padded} bytes")
            out = {r: _to(x[r * C:(r + 1) * C], mesh.devices[p])
                   for r, p in mine}
        if any(t.shape != (C,) for t in out.values()):
            raise ValueError(f"every shard must hold {C} bytes")
        return out

    def fn(x, n) -> int:
        """Checksum of the first n bytes of the sharded buffer (bytes at
        or past n are never read). Returns a Python int, the same in
        every process of the mesh."""
        n = int(n)
        if not 0 <= n <= n_total_padded:
            raise ValueError(f"n={n} outside [0, {n_total_padded}]")
        lens = [min(max(n - r * C, 0), C) for r in range(ndev)]
        vals = []
        for r, t in shards(x).items():
            with _on(t.device):
                vals.append((r, cs._rows(kind, t.unsqueeze(0), [0],
                                         [lens[r]], [_EMPTY[kind]])))
        with _on(home):
            parts = torch.zeros(ndev, dtype=torch.long, device=home)
            for r, v in vals:
                parts[r] = v.to(home)[0]
            if mesh.group is not None:
                import torch.distributed as dist
                every = [torch.empty_like(parts) for _ in
                         range(dist.get_world_size(mesh.group))]
                dist.all_gather(every, parts, group=mesh.group)
                # each shard has one owner; the others gave zeros
                parts = torch.stack(every).sum(0)
            return int(_fold(kind, parts, torch.tensor(lens, device=home)))

    return fn


def make_sharded_crc32(mesh, n_total_padded: int, axis: str = "dp"):
    """Sequence-sharded CRC-32 over a uint8 buffer of n_total_padded
    bytes cut into equal shards along the mesh's `axis` (replicated
    along the other). Returns fn(x, n) -> int, the CRC-32 of the first n
    bytes; x is the whole buffer (a numpy array or tensor, cut and placed
    here) or this process's local shards in mesh order.

    Shard r checksums only its real range [0, clamp(n - r·C, 0, C)), so
    tbz's zero-padding unshift (checksums.py:366) is not needed; lengths
    are 64-bit, so the result is zlib's past n = 2^29 bytes, where tbz's
    uint32 8·n wraps (shard.py:337-340). ValueError unless n_total_padded
    is a multiple of ndev · 128, as tbz asserts."""
    return _make_sharded("crc32", mesh, n_total_padded, axis,
                         CRC_LANE_BYTES)


def make_sharded_adler32(mesh, n_total_padded: int, axis: str = "dp"):
    """Sequence-sharded Adler-32 (the contract of make_sharded_crc32;
    n_total_padded a multiple of ndev · 4096, as tbz asserts). Only the
    real bytes are summed, so tbz's pad-weight correction
    (shard.py:372-375, 391-392) is not needed."""
    return _make_sharded("adler32", mesh, n_total_padded, axis,
                         ADLER_CHUNK)
