"""Sharded decode, the port of tbz/parallel/shard.py: data-parallel
streams and sequence-parallel checksums over a mesh (parallel/mesh.py).

Independent streams (BASELINE config 5's shape: gzip members, deflate
streams): host tokenizers (native, a thread pool) parse every member;
members are grouped into power-of-two size buckets (tape length, output
capacity, input length) so one huge stream does not pad the small ones;
each bucket's rows are cut into contiguous blocks over the mesh's 'dp'
axis, as tbz's P("dp") places them, and each device resolves its block
(kernel 7, one row a member) and checksums it (kernels 5 and 6, only the
kinds its framing needs); outputs come back in stream order.

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

from .. import checksums as cs
from ..ops import resolve as R
from ..ops.resolve import _resolve_batch
from .mesh import make_mesh, process_rank

W = R.W
# tbz's shard alignment: its CRC folds 128-byte lanes, its Adler
# 4096-byte chunks (tbz/checksums.py CRC_LANE_BYTES, ADLER_CHUNK)
CRC_LANE_BYTES = 128
ADLER_CHUNK = 4096

# the batched checksums of tbz/parallel/shard.py:46/53 (CRC from 0,
# Adler from 1, over rows[s, :lens[s]])
_crc_batch = cs.crc32_device_tail_batch
_adler_batch = cs.adler32_device_tail_batch


def _pow2(n, floor):
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


def _tokenize_members(payload: bytes, format: str):
    """Host frontend for one payload: parse EVERY member (multi-member
    gzip supported). Returns a list of member dicts."""
    from .. import api, frontend
    from ..errors import TruncatedError
    from ..formats import gzip_fmt, zlib_fmt

    payload = bytes(payload)
    fmt = api.detect_format(payload) if format == "auto" else format
    members = []
    pos = 0
    while True:
        if fmt == "gzip":
            hdr = gzip_fmt.parse_header(payload, pos)
            body = payload[hdr.data_offset:]
            res = frontend.tokenize(body)
            if not res.finished:
                raise TruncatedError("member body truncated")
            end = (res.end_bit + 7) // 8
            crc, isize = gzip_fmt.read_trailer(body, end)
            members.append(dict(fmt=fmt, body=body, res=res,
                                kind="crc32", expect=crc, isize=isize))
            pos = hdr.data_offset + end + 8
            if pos + 2 > len(payload) or payload[pos:pos + 2] != b"\x1f\x8b":
                # Bytes after a complete member that don't start another
                # member are benign trailing garbage — the same policy as
                # api.decompress (unused_data) and zlib.decompressobj(31).
                break
        elif fmt == "zlib":
            hdr = zlib_fmt.parse_header(payload)
            body = payload[hdr.data_offset:]
            res = frontend.tokenize(body)
            if not res.finished:
                raise TruncatedError("member body truncated")
            data_end = (res.end_bit + 7) // 8
            adler = zlib_fmt.read_trailer(body, data_end)
            # bytes past the adler trailer: benign unused_data, matching
            # api.decompress (zlib.decompressobj semantics)
            members.append(dict(fmt=fmt, body=body, res=res,
                                kind="adler32", expect=adler, isize=None))
            break
        else:
            res = frontend.tokenize(payload)
            if not res.finished:
                raise TruncatedError("member body truncated")
            members.append(dict(fmt=fmt, body=payload, res=res,
                                kind=None, expect=None, isize=None))
            break
    return members


def _bucket_key(mem) -> tuple:
    t = mem["res"].tape
    return (_pow2(len(t), 1024), _pow2(t.total_out, 4096),
            _pow2(len(mem["body"]), 1024))


def _stage_bucket(its, T: int, M: int, pool):
    """Host arrays of one bucket: tapes int32[S, T], counts, inputs
    uint8[S, M] (rows filled in parallel; large numpy copies release the
    GIL). Returns (out_len, dist, root_val, n_tokens, total_out, inputs)."""
    S = len(its)
    out_len = np.empty((S, T), np.int32)
    dist = np.empty((S, T), np.int32)
    root_val = np.empty((S, T), np.int32)
    n_tokens = np.zeros(S, np.int32)
    total_out = np.zeros(S, np.int64)
    inputs = np.empty((S, M), np.uint8)

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

    list(pool.map(row, range(S)))
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


def _resolve_batch_on_mesh(mesh, staged, cap: int) -> list:
    """Resolve a bucket's staged host arrays (out_len, dist, root_val,
    n_tokens, total_out, inputs; S rows each) block by block on the mesh.
    Returns [(lo, hi, bodies)] for the blocks this process owns: bodies
    uint8[hi - lo, cap] on the block's device hold rows lo..hi-1, each
    row's output in [0, total_out). The counterpart of the
    `out.addressable_shards` of tbz's sharded _resolve_batch."""
    ol, di, rv, nt, tot, inp = staged
    me = process_rank()
    out = []
    for dev, lo, hi, rank in _row_blocks(mesh, len(nt)):
        if rank != me or lo >= hi:
            continue
        with _on(dev):
            win = torch.zeros(hi - lo, W, dtype=torch.uint8, device=dev)
            bodies, _ = _resolve_batch(
                *_upload((ol[lo:hi], di[lo:hi], rv[lo:hi], nt[lo:hi]), dev),
                tot[lo:hi], *_upload((inp[lo:hi],), dev), win, cap)
        out.append((lo, hi, bodies))
    return out


def decode_streams_sharded(payloads: list[bytes], mesh=None,
                           format: str = "auto", verify: bool = True,
                           return_errors: bool = False,
                           device_resident: bool = False):
    """Decode independent raw/zlib/gzip streams data-parallel over the
    mesh's 'dp' axis (default: a mesh over every local CUDA card; a CPU
    mesh, make_mesh(devices=["cpu"] * k), runs the plain versions).
    Returns a list of per-stream outputs (bytes), in stream order. With
    return_errors=True, a corrupt stream yields its exception object at
    its position instead of aborting the batch; otherwise the first error
    is raised after all healthy streams were decoded.

    device_resident=True keeps decoded bytes on the devices: each
    stream's entry is a list of (uint8 row tensor, length) members
    (consumers slice row[:length]); only the checksum values cross to
    the host.

    A mesh that spans processes raises ValueError: this process cannot
    fetch another's rows (run _resolve_batch_on_mesh on each process).
    """
    from ..errors import DeflateError
    from ..formats import gzip_fmt, zlib_fmt

    if mesh is None:
        mesh = make_mesh(sp=1)
    if not mesh.is_local():
        raise ValueError("decode_streams_sharded needs a mesh of this "
                         "process's devices")
    n_threads = min(32, max(4, os.cpu_count() or 4))

    def front(p):
        try:
            return _tokenize_members(p, format)
        except DeflateError as e:
            return e

    with concurrent.futures.ThreadPoolExecutor(n_threads) as pool:
        per_stream = list(pool.map(front, payloads))

        buckets: dict = {}
        for si, m in enumerate(per_stream):
            if isinstance(m, Exception):
                continue
            for mi, mem in enumerate(m):
                buckets.setdefault(_bucket_key(mem), []).append((si, mi, mem))

        member_out: dict = {}
        member_err: dict = {}
        for (T, cap, M), its in buckets.items():
            staged = _stage_bucket(its, T, M, pool)
            total_out = staged[4]
            for lo, hi, bodies in _resolve_batch_on_mesh(mesh, staged, cap):
                kinds = {mem["kind"] for _, _, mem in its[lo:hi]}
                with _on(bodies.device):
                    crcs = (_crc_batch(bodies, total_out[lo:hi]).cpu()
                            .numpy() if verify and "crc32" in kinds
                            else None)
                    adlers = (_adler_batch(bodies, total_out[lo:hi]).cpu()
                              .numpy() if verify and "adler32" in kinds
                              else None)
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
                    member_out[(si, mi)] = (
                        (bodies[i], n) if device_resident
                        else bodies[i, :n].cpu().numpy().tobytes())

    outputs: list = []
    first_error = None
    for si, m in enumerate(per_stream):
        err = m if isinstance(m, Exception) else member_err.get(si)
        if err is not None:
            outputs.append(err)
            first_error = first_error or err
        elif device_resident:
            outputs.append([member_out[(si, mi)] for mi in range(len(m))])
        else:
            outputs.append(b"".join(member_out[(si, mi)]
                                    for mi in range(len(m))))
    if first_error is not None and not return_errors:
        raise first_error
    return outputs


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
