"""Chunked streaming decode — the reference's defining capability
(README.md:63-73): suspend at ANY input split point and resume with more
input, carrying the 32KB history window across calls.

The reference does this with a byte-granular state machine saved/restored
via with-cached-state (deflate.lisp:114-137, util.lisp:25-46). Here the
same contract is kept with a token-granular incremental tokenizer: before
each symbol/header attempt the (cheap) bit-reader state is snapshotted;
an input underrun restores the snapshot and returns cleanly, so a stream
split at any byte produces identical output — verified by the ported
random-chunking fuzz (test-chunked-input.lisp:54-75's 30k-iteration
strategy). Decode state is a flat dict of numbers + small arrays
(get_state/set_state), preserving the reference's checkpointability
(SURVEY §5.4) in host form.

This is tbz/streaming.py's copy, host code as it is in tbz: the native
inflater (native/frontend.cc) when the library built, else the Python
one; both give the same bytes. Checkpoint blobs are tbz's format, so a
blob written by either package restores in the other.
"""

from __future__ import annotations

import zlib as _zlib

import numpy as np

from . import constants as C
from . import huffman, reference
from .bitreader import BitReader
from .errors import (DeflateError, TruncatedError,
                     ERR_BAD_BLOCK_TYPE, ERR_STORED_LEN_MISMATCH)
from .formats import gzip_fmt, zlib_fmt
from .native import loader
from .tape import STORED_FLAG, TokenTape


class IncrementalInflater:
    """Raw-deflate incremental tokenizer. feed() returns (tape, src_bytes)
    where stored-token offsets index into src_bytes."""

    MODE_BLOCK = 0
    MODE_DATA = 1
    MODE_STORED = 2
    MODE_DONE = 3

    def __init__(self, window_len: int = 0):
        self.mode = self.MODE_BLOCK
        self.bfinal = False
        self.lit_table: np.ndarray | None = None
        self.dist_table: np.ndarray | None = None
        self.stored_remaining = 0
        self.produced = 0
        self.window_len = window_len
        self.buf = b""
        self.bit_pos = 0  # bit offset into self.buf
        self.suspended = False  # last feed stopped on the max_out budget

    @property
    def finished(self) -> bool:
        return self.mode == self.MODE_DONE

    def trailing_bytes(self) -> bytes:
        """Unconsumed input past the final block (after byte-align)."""
        assert self.finished
        return self.buf[(self.bit_pos + 7) // 8:]

    def feed(self, data: bytes, max_out: int = 0) -> tuple[TokenTape, bytes]:
        """Tokenize buffered+new input. max_out > 0 bounds the output
        bytes tagged this call (token-granular, overshoot <= 257) — the
        reference's output-overflow protocol: work and memory stay
        O(max_out), not O(everything fed)."""
        self.buf += data
        src = self.buf
        br = BitReader(src, self.bit_pos)
        out_len: list[int] = []
        dist: list[int] = []
        root_val: list[int] = []
        produced0 = self.produced
        self.suspended = False

        def snap():
            return br.buf, br.nbits, br.byte_pos

        def restore(s):
            br.buf, br.nbits, br.byte_pos = s

        while self.mode != self.MODE_DONE:
            if max_out and self.produced - produced0 >= max_out:
                self.suspended = True
                break
            if self.mode == self.MODE_BLOCK:
                s = snap()
                try:
                    self.bfinal = bool(br.bits(1))
                    btype = br.bits(2)
                    if btype == C.BTYPE_RESERVED:
                        raise DeflateError("invalid block type 3",
                                           ERR_BAD_BLOCK_TYPE)
                    if btype == C.BTYPE_STORED:
                        br.align_to_byte()
                        ln = br.bits(16)
                        nlen = br.bits(16)
                        if ln != (~nlen & 0xFFFF):
                            raise DeflateError("stored LEN/NLEN mismatch",
                                               ERR_STORED_LEN_MISMATCH)
                        self.stored_remaining = ln
                        self.mode = self.MODE_STORED
                    elif btype == C.BTYPE_STATIC:
                        self.lit_table, self.dist_table = huffman.fixed_tables()
                        self.mode = self.MODE_DATA
                    else:
                        self.lit_table, self.dist_table = (
                            reference._read_dynamic_tables(br))
                        self.mode = self.MODE_DATA
                except TruncatedError:
                    restore(s)
                    break
            elif self.mode == self.MODE_STORED:
                avail = br.bits_available() // 8
                take = min(self.stored_remaining, avail)
                if max_out:
                    take = min(take, max_out - (self.produced - produced0))
                if take:
                    off = br.bit_position() >> 3
                    br.read_bytes_aligned(take)
                    out_len.append(take)
                    dist.append(0)
                    root_val.append(STORED_FLAG | off)
                    self.produced += take
                    self.stored_remaining -= take
                if self.stored_remaining:
                    if max_out and self.produced - produced0 >= max_out:
                        self.suspended = True
                    break  # need more input (or budget)
                self._end_block()
            else:  # MODE_DATA
                s = snap()
                try:
                    op, extra, val = reference._decode_symbol(
                        br, self.lit_table, huffman.KIND_LITLEN)
                    if op == C.OP_LITERAL:
                        out_len.append(1)
                        dist.append(0)
                        root_val.append(val)
                        self.produced += 1
                    elif op == C.OP_END:
                        self._end_block()
                    else:
                        length = val + (br.bits(extra) if extra else 0)
                        dop, dextra, dval = reference._decode_symbol(
                            br, self.dist_table, huffman.KIND_DIST)
                        assert dop == C.OP_MATCH
                        d = dval + (br.bits(dextra) if dextra else 0)
                        if d > self.produced + self.window_len:
                            raise DeflateError("distance too far back")
                        out_len.append(length)
                        dist.append(d)
                        root_val.append(0)
                        self.produced += length
                except TruncatedError:
                    restore(s)
                    break

        self.bit_pos = br.bit_position()
        tape = TokenTape.from_lists(out_len, dist, root_val)
        return tape, src

    def _end_block(self):
        self.mode = self.MODE_DONE if self.bfinal else self.MODE_BLOCK

    def trim(self):
        """Drop consumed whole bytes (call after resolving the tape —
        stored-token offsets reference the pre-trim buffer)."""
        drop = self.bit_pos >> 3
        if drop:
            self.buf = self.buf[drop:]
            self.bit_pos -= drop << 3

    def get_state(self) -> dict:
        return {
            "mode": self.mode, "bfinal": self.bfinal,
            "lit_table": self.lit_table, "dist_table": self.dist_table,
            "stored_remaining": self.stored_remaining,
            "produced": self.produced, "window_len": self.window_len,
            "buf": self.buf, "bit_pos": self.bit_pos,
        }

    def set_state(self, s: dict):
        for k, v in s.items():
            setattr(self, k, v)


class _NativeInflater:
    """Token-granular incremental tokenizer over the C++ frontend — the
    same interface as IncrementalInflater, carrying mid-block state
    (decode tables + bit position) in an opaque native TokState, so
    resume never re-parses block data: total work is O(n) for ANY input
    chunking (the round-1 block-granular version re-tokenized the
    incomplete trailing block per chunk — quadratic at small chunks).
    ~100x the Python inflater's throughput for streaming decode."""

    def __init__(self, window_len: int = 0):
        self.window_len = window_len
        self.buf = b""
        self.bit_pos = 0
        self.produced = 0
        self.finished = False
        self.suspended = False
        self._state = loader.new_stream_state()
        self._end_bit = 0

    def feed(self, data: bytes, max_out: int = 0):
        self.buf += data
        src = self.buf
        res, self.suspended = loader.tokenize_stream(
            self._state, src, self.bit_pos, self.window_len, self.produced,
            max_out)
        self.produced += res.tape.total_out
        self.finished = res.finished
        self._end_bit = res.end_bit
        return res.tape, src

    def trim(self):
        drop = self._end_bit >> 3
        if drop:
            self.buf = self.buf[drop:]
        self.bit_pos = self._end_bit - (drop << 3)

    def trailing_bytes(self) -> bytes:
        assert self.finished
        return self.buf[(self.bit_pos + 7) // 8:]

    def get_state(self) -> dict:
        """Serializable checkpoint (the native TokState is a flat POD
        struct — carried as raw bytes)."""
        return {
            "native_state": bytes(self._state.raw),
            "window_len": self.window_len, "buf": self.buf,
            "bit_pos": self.bit_pos, "produced": self.produced,
            "finished": self.finished, "suspended": self.suspended,
            "end_bit": self._end_bit,
        }

    def set_state(self, s: dict):
        self._state = loader.new_stream_state()
        raw = s["native_state"]
        if len(raw) != len(self._state.raw):
            # TokState is a flat POD struct; a size mismatch means the
            # blob came from a different build of the native runtime —
            # memmoving it would misinterpret raw bytes as state.
            raise ValueError(
                f"checkpoint native state is {len(raw)} bytes but this "
                f"build's TokState is {len(self._state.raw)}; restore "
                "requires the same native runtime version")
        import ctypes
        ctypes.memmove(self._state, raw, len(raw))
        self.window_len = s["window_len"]
        self.buf = s["buf"]
        self.bit_pos = s["bit_pos"]
        self.produced = s["produced"]
        self.finished = s["finished"]
        self.suspended = s["suspended"]
        self._end_bit = s["end_bit"]


def _make_inflater(window_len: int):
    if loader.available():
        return _NativeInflater(window_len)
    return IncrementalInflater(window_len)


# --- checkpoint blob codec --------------------------------------------------
# Tag-length-value serialization for Decompressor.checkpoint(): the value
# universe is closed (scalars, bytes, numpy arrays, the two header
# dataclasses, lists/dicts of those), so restoring is pure data
# reconstruction — no pickle, nothing executable in a blob.

_CKPT_MAGIC = b"TBZC\x02"


def _ckpt_ser(obj, parts: list):
    import dataclasses
    if obj is None:
        parts.append(b"N")
    elif obj is True:
        parts.append(b"T")
    elif obj is False:
        parts.append(b"F")
    elif isinstance(obj, int):
        b = obj.to_bytes((obj.bit_length() + 8) // 8 or 1, "little",
                         signed=True)
        parts.append(b"i" + len(b).to_bytes(1, "little") + b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        parts.append(b"b" + len(b).to_bytes(8, "little") + b)
    elif isinstance(obj, str):
        b = obj.encode("utf-8", "surrogateescape")
        parts.append(b"s" + len(b).to_bytes(8, "little") + b)
    elif isinstance(obj, np.ndarray):
        dt = obj.dtype.str.encode()
        b = np.ascontiguousarray(obj).tobytes()
        parts.append(b"a" + len(dt).to_bytes(1, "little") + dt
                     + len(obj.shape).to_bytes(1, "little"))
        for d in obj.shape:
            parts.append(int(d).to_bytes(8, "little"))
        parts.append(len(b).to_bytes(8, "little") + b)
    elif isinstance(obj, (list, tuple)):
        parts.append(b"l" + len(obj).to_bytes(8, "little"))
        for v in obj:
            _ckpt_ser(v, parts)
    elif isinstance(obj, dict):
        parts.append(b"d" + len(obj).to_bytes(8, "little"))
        for k, v in obj.items():
            _ckpt_ser(str(k), parts)
            _ckpt_ser(v, parts)
    elif dataclasses.is_dataclass(obj):
        name = type(obj).__name__
        if name not in ("GzipHeader", "ZlibHeader"):
            raise TypeError(f"checkpoint cannot serialize {name}")
        parts.append(b"H")
        _ckpt_ser(name, parts)
        _ckpt_ser(dataclasses.asdict(obj), parts)
    else:
        raise TypeError(f"checkpoint cannot serialize {type(obj)!r}")


def _ckpt_dumps(obj) -> bytes:
    parts = [_CKPT_MAGIC]
    _ckpt_ser(obj, parts)
    return b"".join(parts)


def _ckpt_u64(blob: bytes, pos: int) -> int:
    raw = blob[pos:pos + 8]
    if len(raw) != 8:
        raise ValueError("truncated checkpoint blob")
    return int.from_bytes(raw, "little")


def _ckpt_de(blob: bytes, pos: int):
    tag = blob[pos:pos + 1]
    if not tag:
        raise ValueError("truncated checkpoint blob")
    pos += 1
    if tag == b"N":
        return None, pos
    if tag == b"T":
        return True, pos
    if tag == b"F":
        return False, pos
    if tag == b"i":
        n = blob[pos]
        raw = blob[pos + 1:pos + 1 + n]
        if len(raw) != n:
            raise ValueError("truncated checkpoint blob")
        return int.from_bytes(raw, "little", signed=True), pos + 1 + n
    if tag in (b"b", b"s"):
        n = _ckpt_u64(blob, pos)
        raw = blob[pos + 8:pos + 8 + n]
        if len(raw) != n:
            raise ValueError("truncated checkpoint blob")
        return (raw if tag == b"b"
                else raw.decode("utf-8", "surrogateescape")), pos + 8 + n
    if tag == b"a":
        dn = blob[pos]
        dt = blob[pos + 1:pos + 1 + dn].decode()
        pos += 1 + dn
        nd = blob[pos]
        pos += 1
        shape = []
        for _ in range(nd):
            shape.append(_ckpt_u64(blob, pos))
            pos += 8
        n = _ckpt_u64(blob, pos)
        raw = blob[pos + 8:pos + 8 + n]
        if len(raw) != n:
            raise ValueError("truncated checkpoint blob")
        return np.frombuffer(raw, dt).reshape(shape).copy(), pos + 8 + n
    if tag == b"l":
        n = _ckpt_u64(blob, pos)
        pos += 8
        out = []
        for _ in range(n):
            v, pos = _ckpt_de(blob, pos)
            out.append(v)
        return out, pos
    if tag == b"d":
        n = _ckpt_u64(blob, pos)
        pos += 8
        out = {}
        for _ in range(n):
            k, pos = _ckpt_de(blob, pos)
            v, pos = _ckpt_de(blob, pos)
            out[k] = v
        return out, pos
    if tag == b"H":
        name, pos = _ckpt_de(blob, pos)
        fields, pos = _ckpt_de(blob, pos)
        if name == "GzipHeader":
            from .formats.gzip_fmt import GzipHeader as K
        elif name == "ZlibHeader":
            from .formats.zlib_fmt import ZlibHeader as K
        else:
            raise ValueError(f"unknown checkpoint header type {name!r}")
        return K(**fields), pos
    raise ValueError(f"bad checkpoint tag {tag!r} at offset {pos - 1}")


def _ckpt_loads(blob: bytes):
    if blob[:len(_CKPT_MAGIC)] != _CKPT_MAGIC:
        raise ValueError(
            "not a tbz checkpoint blob (or from an incompatible version): "
            f"bad magic {blob[:5]!r}")
    obj, _ = _ckpt_de(blob, len(_CKPT_MAGIC))
    return obj


class Decompressor:
    """Streaming multi-format decompressor.

    >>> d = Decompressor("gzip")
    >>> out = b"".join([d.decompress(chunk) for chunk in chunks]) + d.flush()

    Raises on malformed input / checksum mismatch at the earliest point
    of detection. Handles multi-member gzip. `eof` mirrors
    zlib.decompressobj; `unused_data` holds bytes past the stream end.
    """

    S_HEADER, S_BODY, S_TRAILER, S_DONE = range(4)

    #: input slice fed to the tokenizer per bounded-mode iteration — the
    #: unit of input-side memory in the O(max_length + SLICE + 32KB) bound
    SLICE = 1 << 18

    def __init__(self, format: str = "auto", zdict: bytes = b"",
                 verify: bool = True):
        self.format = format
        self.zdict = zdict
        self.verify = verify
        self.state = self.S_HEADER
        self._hdr_buf = b""
        self._inflater: IncrementalInflater | None = None
        self.window = b""
        self.header = None
        self.members: list = []
        self._cksum = 0
        self._member_out = 0
        self.unused_data = b""
        self.eof = False
        self._pending = b""  # produced output withheld by max_length
        # input not yet handed to the state machine (bounded mode):
        # list of chunks + offset into the first, O(1) amortized take
        self._tail: list[bytes] = []
        self._tail_off = 0
        self._tail_len = 0

    # --- bounded-mode input queue ------------------------------------------

    def _tail_push(self, data: bytes):
        if data:
            self._tail.append(data)
            self._tail_len += len(data)

    def _tail_take(self, n: int) -> bytes:
        parts = []
        got = 0
        while self._tail and got < n:
            head = self._tail[0]
            piece = head[self._tail_off:self._tail_off + (n - got)]
            got += len(piece)
            parts.append(piece)
            self._tail_off += len(piece)
            if self._tail_off >= len(head):
                self._tail.pop(0)
                self._tail_off = 0
        self._tail_len -= got
        return b"".join(parts)

    @property
    def unconsumed_tail(self) -> bytes:
        """Input withheld from decoding by max_length (it is re-fed
        automatically on later calls; exposed for zlib parity)."""
        if not self._tail:
            return b""
        return b"".join([self._tail[0][self._tail_off:]] + self._tail[1:])

    # --- internals ---------------------------------------------------------

    def _detect(self, buf: bytes) -> str | None:
        if len(buf) < 2:
            return None
        from .api import detect_format
        return detect_format(buf)

    def _start_body(self, fmt: str, body_prefix: bytes, max_out=None):
        # Preset dictionary: raw streams take it unconditionally
        # (zlib.decompressobj(-15, zdict=...) semantics); zlib streams
        # only when the header's FDICT flag asked for one (RFC 1950);
        # gzip has no dictionary concept.
        if fmt == "raw" or (fmt == "zlib" and self.header is not None
                            and self.header.fdict):
            self.window = self.zdict[-C.MAX_WINDOW:]
        else:
            self.window = b""
        self._inflater = _make_inflater(len(self.window))
        self._cksum = 0 if fmt in ("gzip", "raw") else 1
        self._member_out = 0
        self.state = self.S_BODY
        return self._pump(body_prefix, max_out)

    def _pump(self, data: bytes, max_out=None):
        """Feed the inflater, resolve new tokens against the window.
        Returns (out, leftover) — leftover is non-None only when a gzip
        member completed with input bytes remaining (the caller loop in
        _decompress_all re-enters header parsing with them; iterative so
        thousands of concatenated members don't recurse)."""
        tape, src = self._inflater.feed(data, max_out or 0)
        if len(tape):
            if isinstance(self._inflater, _NativeInflater):
                out = loader.resolve(tape, src, self.window)
            else:
                out = reference.resolve_host(tape, src, self.window)
        else:
            out = b""
        self._inflater.trim()
        if out:
            self.window = (self.window + out)[-C.MAX_WINDOW:]
            self._member_out += len(out)
            if self.verify:
                if self.format == "gzip":
                    self._cksum = _zlib.crc32(out, self._cksum)
                elif self.format == "zlib":
                    self._cksum = _zlib.adler32(out, self._cksum)
        if self._inflater.finished:
            trailer_input = self._inflater.trailing_bytes()
            self.state = self.S_TRAILER
            self._hdr_buf = b""
            t_out, leftover = self._handle_trailer(trailer_input)
            return out + t_out, leftover
        return out, None

    def _handle_trailer(self, data: bytes):
        """Returns (out, leftover) like _pump."""
        self._hdr_buf += data
        fmt = self.format
        if fmt == "raw":
            self._finish_stream(self._hdr_buf)
            return b"", None
        need = 4 if fmt == "zlib" else 8
        if len(self._hdr_buf) < need:
            return b"", None
        tr, rest = self._hdr_buf[:need], self._hdr_buf[need:]
        if fmt == "zlib":
            stored = int.from_bytes(tr, "big")
            if self.verify:
                zlib_fmt.check_adler(stored, self._cksum)
            self._finish_stream(rest)
            return b"", None
        # gzip: CRC + ISIZE, then maybe another member
        crc = int.from_bytes(tr[:4], "little")
        isize = int.from_bytes(tr[4:], "little")
        if self.verify:
            gzip_fmt.check_trailer(crc, self._cksum, isize, self._member_out)
        self.members.append(self._member_out)
        self.state = self.S_HEADER
        self._hdr_buf = b""
        return b"", (rest if rest else None)

    def _finish_stream(self, unused: bytes):
        self.state = self.S_DONE
        self.eof = True
        self.unused_data = unused

    # --- public ------------------------------------------------------------

    def decompress(self, data: bytes, max_length: int = 0) -> bytes:
        """Feed input; returns decompressed bytes. max_length > 0 bounds
        the returned size AND the decode work/memory (the reference's
        output-overflow protocol, deflate.lisp:121-137 / README.md:80-93
        cost model): at most ~max_length output is decoded per call —
        peak buffered state is O(max_length + SLICE + 32KB window)
        regardless of how much input was fed. Withheld input/output is
        drained by later calls (including with data=b"") or flush()."""
        data = bytes(data)
        if not (max_length and max_length > 0):
            if self._tail_len:
                data = self._tail_take(self._tail_len) + data
            out = self._decompress_all(data)
            if self._pending:
                out = self._pending + out
                self._pending = b""
            return out
        # Bounded mode: drain withheld output first, then decode from
        # the input queue in SLICE-sized pieces under a shrinking budget.
        parts = []
        budget = max_length
        if self._pending:
            take, self._pending = (self._pending[:budget],
                                   self._pending[budget:])
            parts.append(take)
            budget -= len(take)
        self._tail_push(data)
        while budget > 0:
            piece = self._tail_take(self.SLICE)
            out = self._decompress_all(piece, budget)
            if out:
                take, excess = out[:budget], out[budget:]
                parts.append(take)
                budget -= len(take)
                self._pending += excess
            if self.state == self.S_DONE:
                self.unused_data += self._tail_take(self._tail_len)
                break
            if not piece and not out:
                break  # no progress possible without new input
        return b"".join(parts)

    @property
    def pending_output(self) -> int:
        """Bytes produced but withheld by a previous max_length."""
        return len(self._pending)

    def _decompress_all(self, data: bytes, max_out=None) -> bytes:
        """Iterative state-machine driver: a gzip member boundary hands
        leftover bytes back to this loop (never recursion — BGZF-style
        files carry thousands of members in one call). max_out bounds
        output decoded this call; input beyond the budget returns to the
        bounded-mode queue."""
        parts = []
        produced = 0
        leftover = bytes(data)
        while leftover is not None:
            if max_out is not None and produced >= max_out:
                if self._tail_off:  # materialize before prepending
                    self._tail[0] = self._tail[0][self._tail_off:]
                    self._tail_off = 0
                self._tail.insert(0, leftover)
                self._tail_len += len(leftover)
                break
            budget = None if max_out is None else max_out - produced
            out, leftover = self._step(leftover, budget)
            if out:
                parts.append(out)
                produced += len(out)
        return b"".join(parts)

    def _step(self, data: bytes, max_out=None):
        """One state-machine advance. Returns (out, leftover|None)."""
        if self.state == self.S_DONE:
            self.unused_data += data
            return b"", None
        if self.state == self.S_TRAILER:
            return self._handle_trailer(data)
        if self.state == self.S_BODY:
            return self._pump(data, max_out)
        # S_HEADER
        self._hdr_buf += data
        if self.format == "auto":
            fmt = self._detect(self._hdr_buf)
            if fmt is None:
                return b"", None
            self.format = fmt
        if self.format == "raw":
            buf, self._hdr_buf = self._hdr_buf, b""
            return self._start_body("raw", buf, max_out)
        if self.format == "zlib":
            try:
                hdr = zlib_fmt.parse_header(self._hdr_buf, self.zdict)
            except TruncatedError:
                return b"", None
            self.header = hdr
            body = self._hdr_buf[hdr.data_offset:]
            self._hdr_buf = b""
            return self._start_body("zlib", body, max_out)
        # gzip
        if (self.members and len(self._hdr_buf) >= 2
                and self._hdr_buf[:2] != b"\x1f\x8b"):
            # After a complete member, non-magic bytes are trailing
            # garbage, not an error (stdlib gzip semantics).
            self._finish_stream(self._hdr_buf)
            return b"", None
        try:
            hdr = gzip_fmt.parse_header(self._hdr_buf, 0)
        except TruncatedError:
            return b"", None
        self.header = hdr
        body = self._hdr_buf[hdr.data_offset:]
        self._hdr_buf = b""
        return self._start_body("gzip", body, max_out)

    def flush(self) -> bytes:
        if self._tail_len or self.state in (self.S_BODY, self.S_TRAILER):
            # Decode whatever bounded-mode calls withheld (input queue +
            # pending output), unbounded.
            out = self.decompress(b"")
        else:
            out = self._pending
            self._pending = b""
        if self.eof:
            return out
        if self.state == self.S_HEADER and not self._hdr_buf and not self.members:
            return out  # no input at all
        if self.state == self.S_HEADER and self.members:
            # Complete at a gzip member boundary; pending partial-magic
            # bytes are trailing junk.
            self._finish_stream(self._hdr_buf)
            return out
        # Incomplete stream: raise, but do NOT lose what was already
        # decoded — put it back in _pending so a caller that catches the
        # error and keeps feeding input recovers a gapless output.
        self._pending = out + self._pending
        raise TruncatedError("stream incomplete at flush")

    @property
    def needs_input(self) -> bool:
        return not self.eof

    # --- checkpoint/resume --------------------------------------------------
    # The reference's defining property is that ALL decode state lives in
    # one copyable struct (SURVEY §5.4, util.lisp:25-46 save-state). The
    # same contract here: a Decompressor suspends to a serializable blob
    # at any point between decompress() calls and resumes in a fresh
    # process, byte-exact. Blobs use a versioned tag-length-value format
    # (_ckpt_dumps below) — restoring NEVER executes code from the blob,
    # unlike pickle, and a blob from an incompatible build fails loudly
    # (magic/version check here, native TokState size check in
    # _NativeInflater.set_state).

    def checkpoint(self) -> bytes:
        inf = self._inflater
        inf_state = None
        if inf is not None:
            inf_state = [type(inf).__name__, inf.get_state()]
        return _ckpt_dumps({
            "format": self.format, "zdict": self.zdict,
            "verify": self.verify, "state": self.state,
            "hdr_buf": self._hdr_buf, "window": self.window,
            "header": self.header, "members": self.members,
            "cksum": self._cksum, "member_out": self._member_out,
            "unused_data": self.unused_data, "eof": self.eof,
            "pending": self._pending, "tail": self.unconsumed_tail,
            "inflater": inf_state,
        })

    @classmethod
    def restore(cls, blob: bytes) -> "Decompressor":
        s = _ckpt_loads(blob)
        d = cls(s["format"], zdict=s["zdict"], verify=s["verify"])
        d.state = s["state"]
        d._hdr_buf = s["hdr_buf"]
        d.window = s["window"]
        d.header = s["header"]
        d.members = s["members"]
        d._cksum = s["cksum"]
        d._member_out = s["member_out"]
        d.unused_data = s["unused_data"]
        d.eof = s["eof"]
        d._pending = s["pending"]
        d._tail_push(s["tail"])
        if s["inflater"] is not None:
            kind, inf_state = s["inflater"]
            if kind == "_NativeInflater":
                d._inflater = _make_inflater(inf_state["window_len"])
                if isinstance(d._inflater, _NativeInflater):
                    d._inflater.set_state(inf_state)
                else:  # native runtime not available here: no recovery
                    raise RuntimeError(
                        "checkpoint was taken with the native inflater")
            else:
                d._inflater = IncrementalInflater()
                d._inflater.set_state(inf_state)
        return d


class Compressor:
    """Streaming multi-format compressor (the encode mirror of
    Decompressor; beyond the reference, which has no encoder).

    compress() buffers input and emits completed deflate segments once
    enough is buffered (each segment ends at a Z_FULL_FLUSH sync point);
    flush() emits the final block + trailer. Segments are matched
    independently (no cross-segment back-references), trading a small
    ratio loss for bounded memory.
    """

    SEGMENT = 1 << 20

    def __init__(self, format: str = "zlib", level: int = 6,
                 mtime: int = 0, name: str | None = None,
                 zdict: bytes = b"", wbits: int = 15):
        assert format in ("raw", "zlib", "gzip")
        if zdict and format == "gzip":
            raise ValueError("gzip has no preset-dictionary concept")
        if not 9 <= wbits <= 15:
            raise ValueError(f"wbits must be 9..15, got {wbits}")
        self.format = format
        self.level = level
        self.wbits = wbits
        self._buf = b""
        self._started = False
        self._cksum = 1 if format == "zlib" else 0
        self._total = 0
        self._mtime = mtime
        self._name = name
        self._done = False
        # preset dictionary: back-references for the FIRST segment only
        # (segments are independently matched; later segments simply
        # don't use it — valid output either way)
        self._zdict = bytes(zdict)

    def _header(self) -> bytes:
        if self.format == "raw":
            return b""
        if self.format == "zlib":
            cmf = 0x08 | ((self.wbits - 8) << 4)
            flevel = (0 if self.level < 2 else 1 if self.level < 6
                      else 2 if self.level < 8 else 3)
            flg = (flevel << 6) | (0x20 if self._zdict else 0)
            rem = ((cmf << 8) | flg) % 31
            if rem:
                flg += 31 - rem
            hdr = bytes([cmf, flg])
            if self._zdict:
                hdr += _zlib.adler32(self._zdict).to_bytes(4, "big")
            return hdr
        flg = 0x08 if self._name is not None else 0
        name_b = (self._name.encode("utf-8") + b"\x00"
                  if self._name is not None else b"")
        xfl = 2 if self.level >= 8 else 4 if self.level <= 2 else 0
        return (b"\x1f\x8b\x08" + bytes([flg])
                + int(self._mtime).to_bytes(4, "little")
                + bytes([xfl, 3]) + name_b)

    def _update_cksum(self, piece: bytes) -> None:
        if self.format == "zlib":
            self._cksum = _zlib.adler32(piece, self._cksum)
        elif self.format == "gzip":
            self._cksum = _zlib.crc32(piece, self._cksum)
        self._total += len(piece)

    def compress(self, data: bytes) -> bytes:
        if self._done:
            raise ValueError("compressor already flushed")
        from . import deflate_encode as de
        self._buf += bytes(data)
        out = b"" if self._started else self._header()
        self._started = True
        while len(self._buf) >= 2 * self.SEGMENT:
            seg, self._buf = (self._buf[:self.SEGMENT],
                              self._buf[self.SEGMENT:])
            self._update_cksum(seg)
            out += de.deflate_raw(seg, self.level, final=False,
                                  zdict=self._take_zdict(),
                                  max_dist=1 << self.wbits)
        return out

    def sync_flush(self) -> bytes:
        """Emit all buffered input as completed non-final blocks ending
        at a byte-aligned empty stored block (the zlib Z_SYNC_FLUSH /
        Z_FULL_FLUSH marker, 00 00 FF FF). The stream stays open:
        compress() continues it. Segments are independently matched, so
        sync and full flush coincide (the dictionary is already not
        carried across segments)."""
        if self._done:
            raise ValueError("compressor already flushed")
        from . import deflate_encode as de
        out = b"" if self._started else self._header()
        self._started = True
        seg, self._buf = self._buf, b""
        self._update_cksum(seg)
        out += de.deflate_raw(seg, self.level, final=False,
                              zdict=self._take_zdict(),
                              max_dist=1 << self.wbits)
        return out

    def _take_zdict(self) -> bytes:
        z, self._zdict = self._zdict, b""
        return z

    def flush(self) -> bytes:
        from . import deflate_encode as de
        if self._done:
            raise ValueError("compressor already flushed")
        self._done = True
        out = b"" if self._started else self._header()
        self._update_cksum(self._buf)
        out += de.deflate_raw(self._buf, self.level, final=True,
                              zdict=self._take_zdict(),
                              max_dist=1 << self.wbits)
        self._buf = b""
        if self.format == "zlib":
            out += int(self._cksum).to_bytes(4, "big")
        elif self.format == "gzip":
            out += int(self._cksum).to_bytes(4, "little")
            out += (self._total % (1 << 32)).to_bytes(4, "little")
        return out
