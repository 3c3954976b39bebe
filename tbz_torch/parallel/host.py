"""Decode and encode of independent streams from a pool of host threads
(the port of tbz/parallel/host.py).

`decompress_many` decodes N independent raw/zlib/gzip streams
concurrently, each through api.decompress, so on the card (`cuda`) by
default and raising without one (device="cpu": the kernels' plain
versions; backend="host": the native host inflate). The host stages of
each decode (header scan and chain walk, C++ through ctypes) release
the GIL and overlap across threads; the kernels of every thread go to
the legacy default stream of the card and run one after another. With
caller-provided output buffers (`out=`, the known-size decompress-into
contract, api.lisp:36-48) each stream goes through api.decompress_into,
the native host inflate, as in tbz; no kernel runs then.

`compress_many` is host code, as in tbz. For the mesh-sharded decode of
a batch on the card use parallel.shard.decode_streams_sharded.
"""

from __future__ import annotations

import concurrent.futures
import os

from .. import api as _api
from ..errors import DeflateError

__all__ = ["compress_many", "decompress_many"]


def decompress_many(payloads, format: str = "auto", *, threads: int = 0,
                    out=None, verify: bool = True,
                    return_errors: bool = False, backend: str | None = None,
                    device=None):
    """Decode independent streams concurrently on host threads.

    payloads: list of bytes-like compressed streams (raw/zlib/gzip,
    per-stream auto-detect with format="auto").
    threads: pool width; 0 = min(32, CPUs).
    out: optional list of writable per-stream buffers (bytearray /
    writable memoryview / uint8 ndarray), each at least the stream's
    decompressed size — decoded by the native host inflate into them,
    returning (buffer, n_written) pairs instead of bytes.
    return_errors: a corrupt stream yields its exception object at its
    position instead of aborting the batch (the per-stream error-value
    contract parallel.shard also follows); otherwise the first error
    propagates after all healthy streams finish.
    backend, device: passed to api.decompress (ignored with `out`).

    Returns a list in stream order: bytes (no `out`) or
    (buffer, n_written) tuples (with `out`).
    """
    payloads = list(payloads)
    if out is not None:
        out = list(out)
        if len(out) != len(payloads):
            raise ValueError("out must have one buffer per payload")
    n_threads = threads or min(32, os.cpu_count() or 4)

    def one(i):
        if out is None:
            return _api.decompress(payloads[i], format, verify=verify,
                                   backend=backend, device=device)
        n = _api.decompress_into(payloads[i], out[i], format,
                                 verify=verify)
        return (out[i], n)

    def guarded(i):
        try:
            return one(i)
        except DeflateError as e:
            return e

    with concurrent.futures.ThreadPoolExecutor(n_threads) as ex:
        results = list(ex.map(guarded, range(len(payloads))))
    if not return_errors:
        for r in results:
            if isinstance(r, DeflateError):
                raise r
    return results


def compress_many(datas, format: str = "zlib", level: int | None = None,
                  *, threads: int = 0, return_errors: bool = False,
                  **kw):
    """Compress independent buffers concurrently on host threads (the
    matcher / block planner / emitter are C++ and release the GIL).
    For ONE large buffer use tbz_torch.compress(data, threads=N) instead
    (segment-parallel single stream). kw forwards to api.compress
    (zdict=, wbits=, ...). Returns a list in input order."""
    datas = list(datas)
    n_threads = threads or min(32, os.cpu_count() or 4)

    def one(i):
        try:
            return _api.compress(datas[i], format=format, level=level,
                                 **kw)
        except (DeflateError, ValueError) as e:
            if return_errors:
                return e
            raise

    with concurrent.futures.ThreadPoolExecutor(n_threads) as ex:
        return list(ex.map(one, range(len(datas))))
