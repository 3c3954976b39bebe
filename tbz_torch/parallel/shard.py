"""Batched decode of independent streams on one card, the port of the
one-card part of tbz/parallel/shard.py (BASELINE config 5's shape:
independent gzip members / deflate streams).

Host tokenizers (native, a thread pool) parse every member; members are
grouped into power-of-two size buckets (tape length, output capacity,
input length) so one huge stream does not pad the small ones; each
bucket resolves on the card as one batch (kernel 7, one row a member)
and is checksummed there (kernels 5 and 6, only the kinds its framing
needs); outputs come back in stream order.

Unlike tbz, a device failure is not retried on the host: a kernel or
launch failure raises, and only a DeflateError (a corrupt stream) turns
into that stream's error value.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import torch

from .. import checksums as cs
from ..ops import resolve as R
from ..ops.resolve import _resolve_batch

W = R.W

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


def decode_streams_sharded(payloads: list[bytes], format: str = "auto",
                           verify: bool = True, return_errors: bool = False,
                           device_resident: bool = False, *, device=None):
    """Decode independent raw/zlib/gzip streams as batches on one card
    (`device`, default cuda; device="cpu" runs the plain versions).
    Returns a list of per-stream outputs (bytes), in stream order. With
    return_errors=True, a corrupt stream yields its exception object at
    its position instead of aborting the batch; otherwise the first error
    is raised after all healthy streams were decoded.

    device_resident=True keeps decoded bytes on the device: each stream's
    entry is a list of (uint8 row tensor, length) members (consumers
    slice row[:length]); only the checksum values cross to the host.
    """
    from ..errors import DeflateError
    from ..formats import gzip_fmt, zlib_fmt

    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("decode_streams_sharded needs a CUDA device; "
                           "pass device='cpu'")
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
            ol, di, rv, nt, total_out, inputs = _stage_bucket(its, T, M,
                                                              pool)
            windows = np.zeros((len(its), W), np.uint8)
            bodies, _ = _resolve_batch(
                *_upload((ol, di, rv, nt), device), total_out,
                *_upload((inputs, windows), device), cap)
            kinds = {mem["kind"] for _, _, mem in its}
            crcs = (_crc_batch(bodies, total_out).cpu().numpy()
                    if verify and "crc32" in kinds else None)
            adlers = (_adler_batch(bodies, total_out).cpu().numpy()
                      if verify and "adler32" in kinds else None)
            for i, (si, mi, mem) in enumerate(its):
                n = int(total_out[i])
                try:
                    if verify and mem["kind"] == "crc32":
                        gzip_fmt.check_trailer(mem["expect"], int(crcs[i]),
                                               mem["isize"], n)
                    elif verify and mem["kind"] == "adler32":
                        zlib_fmt.check_adler(mem["expect"], int(adlers[i]))
                except DeflateError as e:
                    member_err[si] = e
                member_out[(si, mi)] = ((bodies[i], n) if device_resident
                                        else bodies[i, :n].cpu().numpy()
                                        .tobytes())

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
