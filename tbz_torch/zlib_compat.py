"""Drop-in `zlib`-module-compatible surface over tbz_torch, the port
of tbz/zlib_compat.py.

`import tbz_torch.zlib_compat as zlib` gives the stdlib signatures —
compress/decompress (wbits-aware), compressobj/decompressobj (incl.
zdict on the decompress side, max_length, unused_data/unconsumed_tail/
eof), crc32/adler32 (+ the crc32_combine/adler32_combine extensions
stdlib lacks) — backed by the tbz_torch encoder/decoder. The migration
story for callers of the reference or of stdlib zlib: change one import.

`decompress` goes through api.decompress, so it decodes on the card
(`cuda`) by default and raises without one; its keyword-only backend=
and device= pass through (device="cpu": the kernels' plain versions;
backend="host": the native host inflate). compressobj / decompressobj
are host code over tbz_torch.streaming, as in tbz.

wbits mapping (zlib manual): 9..15 zlib framing, -9..-15 raw deflate,
16+9..16+15 gzip, 32+9..32+15 auto-detect zlib/gzip, 0 = take the
window size from the zlib header. Window sizes below 32KB are enforced
on encode: match distances are capped at 1<<wbits and the zlib CMF
advertises the matching CINFO, so stdlib decompressobj(wbits) accepts
the stream.

Unlike tbz, which drops the window size of wbits on decode, a zlib
header whose window (CINFO + 8) exceeds wbits raises zlib.error
("invalid window size"), as stdlib does: in decompress, and in
decompressobj as soon as the header's two bytes are in. (A raw or gzip
stream whose distances exceed a window under 32 KB still decodes here,
where stdlib raises "invalid distance too far back".)
"""

from __future__ import annotations

import zlib as _z

from . import api as _api
from . import streaming as _streaming
from .errors import DeflateError as _DeflateError

error = _z.error

Z_DEFAULT_COMPRESSION = -1
Z_BEST_COMPRESSION = 9
Z_BEST_SPEED = 1
Z_NO_COMPRESSION = 0
MAX_WBITS = 15
DEFLATED = 8
DEF_BUF_SIZE = 16384
DEF_MEM_LEVEL = 8

# flush modes (zlib.h)
Z_NO_FLUSH = 0
Z_PARTIAL_FLUSH = 1
Z_SYNC_FLUSH = 2
Z_FULL_FLUSH = 3
Z_FINISH = 4
Z_BLOCK = 5
Z_TREES = 6

# strategies (accepted and ignored — one strategy tier per level)
Z_DEFAULT_STRATEGY = 0
Z_FILTERED = 1
Z_HUFFMAN_ONLY = 2
Z_RLE = 3
Z_FIXED = 4

ZLIB_VERSION = _z.ZLIB_VERSION
ZLIB_RUNTIME_VERSION = _z.ZLIB_RUNTIME_VERSION


def _fmt_from_wbits(wbits: int, side: str = "decompress"):
    """-> (format, window_bits). wbits==0 means 'window size from the
    zlib header' — stdlib accepts it on the DECOMPRESS side only
    (compress with wbits=0 raises in stdlib, so it raises here too)."""
    if wbits == 0:
        if side == "compress":
            raise error("Invalid initialization option")
        return "zlib", 15
    if 9 <= wbits <= 15:
        return "zlib", wbits
    if -15 <= wbits <= -9:
        return "raw", -wbits
    if 25 <= wbits <= 31:
        return "gzip", wbits - 16
    if 41 <= wbits <= 47:
        return "auto", wbits - 32
    raise ValueError(f"invalid wbits {wbits}")


def _check_window(head: bytes, wbits: int) -> None:
    """stdlib's inflate header check on a stream's first two bytes: a
    valid zlib header (FCHECK, method 8) whose window, 1 << (CINFO + 8),
    is larger than the window of wbits raises zlib.error. It applies to
    zlib framing with an explicit window (wbits 9..15) and to
    auto-detect (41..47); wbits 0 takes the window from the header.
    Anything else is left to the decoder's own header errors."""
    window_bits = wbits - 32 if 41 <= wbits <= 47 else wbits
    if (9 <= window_bits <= 15 and len(head) >= 2
            and ((head[0] << 8) | head[1]) % 31 == 0
            and head[0] & 0x0F == DEFLATED
            and (head[0] >> 4) + 8 > window_bits):
        raise error("Error -3 while decompressing data: invalid window size")


def _norm_level(level: int) -> int:
    if level == Z_DEFAULT_COMPRESSION:
        return 6
    if not 0 <= level <= 9:
        raise error(f"Bad compression level {level}")
    return level


def compress(data, /, level: int = Z_DEFAULT_COMPRESSION,
             wbits: int = MAX_WBITS) -> bytes:
    fmt, wb = _fmt_from_wbits(wbits, side="compress")
    if fmt == "auto":
        fmt = "zlib"
    return _api.compress(bytes(data), format=fmt,
                         level=_norm_level(level), wbits=wb)


def decompress(data, /, wbits: int = MAX_WBITS, bufsize: int = 16384, *,
               backend: str | None = None, device=None) -> bytes:
    """stdlib's zlib.decompress, decoded by api.decompress (on the card
    by default; backend= and device= pass through)."""
    del bufsize  # exact two-phase sizing; no growth loop to tune
    fmt, _ = _fmt_from_wbits(wbits)
    data = bytes(data)
    _check_window(data[:2], wbits)
    try:
        return _api.decompress(data, format=fmt, backend=backend,
                               device=device)
    except _DeflateError as e:
        raise error(str(e)) from e


def crc32(data, value: int = 0, /) -> int:
    return _z.crc32(data, value)


def adler32(data, value: int = 1, /) -> int:
    return _z.adler32(data, value)


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """GF(2) matrix combine (an extension: stdlib zlib's C API has
    it, the Python module does not)."""
    from . import checksums as _cs
    return _cs.crc32_combine(crc1, crc2, len2)


def adler32_combine(a1: int, a2: int, len2: int) -> int:
    from . import checksums as _cs
    return _cs.adler32_combine(a1, a2, len2)


class compressobj:
    """zlib.compressobj work-alike (method/memLevel/strategy accepted
    and ignored — the encoder has one strategy tier per level).

    flush(mode): Z_NO_FLUSH is a no-op; Z_PARTIAL/Z_SYNC/Z_FULL_FLUSH
    (and Z_BLOCK/Z_TREES, conservatively byte-aligned) emit pending
    input ending at a sync point and leave the stream open; Z_FINISH
    finalizes. Misuse raises zlib.error, matching stdlib."""

    def __init__(self, level: int = Z_DEFAULT_COMPRESSION,
                 method: int = DEFLATED, wbits: int = MAX_WBITS,
                 memLevel: int = 8, strategy: int = 0,
                 zdict: bytes | None = None):
        del method, memLevel, strategy
        fmt, wb = _fmt_from_wbits(wbits, side="compress")
        if fmt == "auto":
            raise ValueError("compressobj cannot use auto-detect wbits")
        if zdict and fmt == "gzip":
            raise ValueError("cannot use zdict with gzip wbits")
        self._co = _streaming.Compressor(fmt, _norm_level(level),
                                         zdict=zdict or b"", wbits=wb)
        self._flushed = False

    def compress(self, data) -> bytes:
        if self._flushed:
            raise error("Error 90 while compressing data: "
                        "inconsistent stream state")
        return self._co.compress(bytes(data))

    def flush(self, mode: int = Z_FINISH) -> bytes:
        if mode == Z_NO_FLUSH:
            return b""
        if mode in (Z_PARTIAL_FLUSH, Z_SYNC_FLUSH, Z_FULL_FLUSH,
                    Z_BLOCK, Z_TREES):
            if self._flushed:
                raise error("Error 90 while flushing: "
                            "inconsistent stream state")
            return self._co.sync_flush()
        if mode == Z_FINISH:
            if self._flushed:
                return b""
            self._flushed = True
            return self._co.flush()
        raise error(f"Invalid flush mode: {mode}")

    def copy(self) -> "compressobj":
        import copy as _copy
        c = compressobj.__new__(compressobj)
        c._co = _copy.deepcopy(self._co)
        c._flushed = self._flushed
        return c


class decompressobj:
    """zlib.decompressobj work-alike over tbz_torch.streaming.Decompressor
    (byte-granular resume, bounded-memory max_length).

    stdlib's unconsumed_tail contract: input reported there has NOT
    been seen by the decompression machinery and the CALLER re-feeds
    it. streaming.Decompressor retains withheld input internally (its
    own documented contract), so this wrapper manages input itself in
    bounded mode — it feeds budget-scaled bites and keeps the unfed
    remainder as the tail. When the budget is exhausted with all input
    already inside the core and the core possibly still withholding
    output (a small highly-compressed input can be swallowed whole by
    one bite), the tail would read empty and stdlib's documented
    're-feed the tail' loop would terminate with data undelivered — so
    the wrapper reports a VIRTUAL tail (a suffix of bytes already fed)
    and recognizes/skips those bytes when they come back."""

    def __init__(self, wbits: int = MAX_WBITS, zdict: bytes = b""):
        fmt, _ = _fmt_from_wbits(wbits)
        self._wbits = wbits
        self._d = _streaming.Decompressor(fmt, zdict=zdict)
        self._utail = b""       # input the core has genuinely not seen
        self._vtail = b""       # virtual tail: already-fed bytes
        self._last_fed = b""    # suffix of the newest bytes fed
        self._head = b""        # the stream's first bytes, up to 2

    def decompress(self, data, max_length: int = 0) -> bytes:
        data = bytes(data)
        if max_length < 0:
            raise ValueError("max_length must be non-negative")
        if len(self._head) < 2 and data:
            # every call feeds its first bytes to the core, so the
            # header's two bytes are the first two ever passed
            self._head += data[:2 - len(self._head)]
            _check_window(self._head, self._wbits)
        if self._vtail:
            if data[:len(self._vtail)] == self._vtail:
                data = data[len(self._vtail):]  # re-feed: already inside
            self._vtail = b""
        try:
            if max_length == 0:
                self._utail = b""
                return self._d.decompress(data)
            parts = []
            budget = max_length
            # drain output the core already holds (pending/queued input)
            out = self._d.decompress(b"", max_length=budget)
            parts.append(out)
            dry = len(out) < budget  # core cannot produce more unfed
            budget -= len(out)
            off = 0
            while budget > 0 and off < len(data) and not self._d.eof:
                bite = data[off:off + max(4096, min(1 << 18, budget))]
                off += len(bite)
                out = self._d.decompress(bite, max_length=budget)
                parts.append(out)
                dry = len(out) < budget
                budget -= len(out)
            if self._d.eof and off < len(data):
                # post-stream bytes belong to unused_data (stdlib)
                self._d.decompress(data[off:])
                off = len(data)
            if data:
                self._last_fed = data[max(0, off - 4096):off] or \
                    self._last_fed
            self._utail = data[off:]
            if not self._utail and not self._d.eof and not dry:
                self._vtail = self._last_fed
            return b"".join(parts)
        except _DeflateError as e:
            raise error(str(e)) from e

    def flush(self, length: int = 16384) -> bytes:
        del length
        self._vtail = b""  # those bytes are in the core; flush decodes them
        try:
            return self._d.flush()
        except _DeflateError as e:
            raise error(str(e)) from e

    @property
    def eof(self) -> bool:
        return self._d.eof

    @property
    def unused_data(self) -> bytes:
        return self._d.unused_data

    @property
    def unconsumed_tail(self) -> bytes:
        return self._utail or self._vtail

    def copy(self) -> "decompressobj":
        """Fork mid-stream via the checkpoint blob (the same mechanism
        that survives process restarts)."""
        d = decompressobj.__new__(decompressobj)
        d._d = _streaming.Decompressor.restore(self._d.checkpoint())
        d._utail = self._utail
        d._vtail = self._vtail
        d._last_fed = self._last_fed
        d._head = self._head
        d._wbits = self._wbits
        return d
