"""Drop-in stdlib-`gzip`-module-compatible surface over tbz_torch, the
port of tbz/gzip_compat.py.

`import tbz_torch.gzip_compat as gzip` gives the stdlib signatures —
compress/decompress, GzipFile (read/write/append, multi-member, FNAME
and MTIME metadata, seek/tell/rewind, peek, read1), open() including
text modes, BadGzipFile — backed by the encoder and the streaming
decoder of tbz_torch.streaming. It is host code, as in tbz: nothing
here runs on the card (the reference's gzip.lisp covers only the read
side).

Error classes mirror stdlib: invalid framing raises BadGzipFile,
truncation raises EOFError, checksum/length mismatches raise
BadGzipFile. Bytes after a complete member follow stdlib's rule too:
zero padding is skipped, and anything else must begin another member
(BadGzipFile otherwise). tbz instead stops at the first bytes that are
not a member's magic and drops them, so it returns a short result for
members separated by zero padding and accepts trailing garbage.
"""

from __future__ import annotations

import builtins
import io
import os
import time as _time

from . import streaming as _streaming
from .errors import ChecksumError as _ChecksumError
from .errors import DeflateError as _DeflateError
from .errors import TruncatedError as _TruncatedError

__all__ = ["BadGzipFile", "GzipFile", "open", "compress", "decompress"]

READ, WRITE = 1, 2  # GzipFile.mode values (stdlib parity)

_READ_CHUNK = 1 << 17


class BadGzipFile(OSError):
    """Invalid gzip framing / checksum (stdlib parity)."""


def _map_error(e: Exception) -> Exception:
    if isinstance(e, _TruncatedError):
        return EOFError("Compressed file ended before the end-of-stream "
                        "marker was reached")
    if isinstance(e, (_ChecksumError, _DeflateError)):
        return BadGzipFile(str(e))
    return e


def _next_member(rest: bytes, final: bool) -> bytes | None:
    """stdlib gzip's rule for the bytes after a complete member: zero
    padding is skipped, and anything else must begin another member.
    Returns the next member's bytes, or None when there is none (yet:
    unless `final`, fewer than 2 bytes wait for more input)."""
    rest = rest.lstrip(b"\0")
    if not rest or (len(rest) < 2 and not final):
        return None
    if rest[:2] != b"\x1f\x8b":
        raise BadGzipFile(f"Not a gzipped file ({rest[:2]!r})")
    return rest


def compress(data, compresslevel: int = 9, *, mtime=None) -> bytes:
    """Like stdlib gzip.compress: one member, MTIME from `mtime`
    (current time when None)."""
    if mtime is None:
        mtime = _time.time()
    co = _streaming.Compressor("gzip", compresslevel, mtime=int(mtime))
    return co.compress(bytes(data)) + co.flush()


def decompress(data) -> bytes:
    """Like stdlib gzip.decompress: all members, checksums verified."""
    data = bytes(data) or None
    parts = []
    while data is not None:
        d = _streaming.Decompressor("gzip")
        try:
            parts.append(d.decompress(data) + d.flush())
            if not d.eof:
                raise _TruncatedError("gzip stream incomplete")
        except Exception as e:  # noqa: BLE001
            raise _map_error(e) from e
        data = _next_member(d.unused_data, final=True)
    return b"".join(parts)


class GzipFile(io.BufferedIOBase):
    """stdlib gzip.GzipFile work-alike (binary modes).

    Read mode decodes multi-member streams with CRC/ISIZE verification
    per member; `mtime` reflects the most recently read member header.
    Write mode emits FNAME (basename, stdlib rule) and MTIME. Append
    opens the underlying file in append mode and writes a fresh member.
    seek() in read mode rewinds and re-decompresses forward (stdlib
    behavior); in write mode forward seeks pad with zeros.
    """

    myfileobj = None

    def __init__(self, filename=None, mode=None, compresslevel: int = 9,
                 fileobj=None, mtime=None):
        if mode and "t" in mode:
            raise ValueError(f"Invalid mode: {mode!r}")
        if mode and "b" not in mode:
            mode += "b"
        if fileobj is None:
            if filename is None:
                raise TypeError("filename or fileobj required")
            fileobj = self.myfileobj = builtins.open(
                filename, mode or "rb")
        if filename is None:
            filename = getattr(fileobj, "name", "")
            if not isinstance(filename, (str, bytes)):
                filename = ""
        if mode is None:
            mode = getattr(fileobj, "mode", "rb")

        self._fileobj = fileobj
        self.name = filename
        self._size = 0          # uncompressed position / bytes written
        self._closed = False

        if mode.startswith("r"):
            self.mode = READ
            self._writer = None
            self._new_reader()
        elif mode.startswith(("w", "x", "a")):
            self.mode = WRITE
            self._reader = None
            if mtime is None:
                mtime = _time.time()
            self._mtime = int(mtime)
            base = os.path.basename(
                filename if isinstance(filename, str) else "")
            if base.endswith(".gz"):
                base = base[:-3]
            self._writer = _streaming.Compressor(
                "gzip", compresslevel, mtime=self._mtime,
                name=base or None)
        else:
            raise ValueError(f"Invalid mode: {mode!r}")

    # --- shared -------------------------------------------------------------

    def _new_reader(self):
        self._reader = _streaming.Decompressor("gzip")
        self._buf = bytearray()
        self._in_eof = False
        self._mtime = None

    @property
    def mtime(self):
        """Write mode: the MTIME being written. Read mode: the last
        read member header's MTIME (None before any header)."""
        if self._writer is not None:
            return self._mtime
        hdr = self._reader.header
        return hdr.mtime if hdr is not None else None

    def readable(self) -> bool:
        return self._writer is None

    def writable(self) -> bool:
        return self._writer is not None

    def seekable(self) -> bool:
        return True

    def tell(self) -> int:
        self._check_not_closed()
        return self._size

    def _check_not_closed(self):
        if self._closed:
            raise ValueError("I/O operation on closed file")

    # --- read side ----------------------------------------------------------

    def _fill(self, want: int) -> None:
        """Decode until the buffer holds `want` bytes or input ends."""
        try:
            while len(self._buf) < want and not self._in_eof:
                chunk = self._fileobj.read(_READ_CHUNK)
                if not chunk:
                    self._in_eof = True
                    self._buf += self._reader.flush()
                    if not self._reader.eof and self._reader.state != 0:
                        # mid-member at input end: stdlib raises EOFError
                        raise _TruncatedError("gzip stream incomplete")
                    self._start_next_member(final=True)
                    break
                self._buf += self._reader.decompress(chunk)
                self._start_next_member(final=False)
        except Exception as e:  # noqa: BLE001
            raise _map_error(e) from e

    def _start_next_member(self, final: bool) -> None:
        """Past a complete member, go on with a fresh reader at the next
        member (stdlib's rule, _next_member); at the end of the input
        (`final`), decode it to its end."""
        while self._reader.eof:
            rest = _next_member(self._reader.unused_data, final)
            if rest is None:
                return
            self._reader = _streaming.Decompressor("gzip")
            self._buf += self._reader.decompress(rest)
            if final:
                self._buf += self._reader.flush()
                if not self._reader.eof:
                    raise _TruncatedError("gzip stream incomplete")

    def read(self, size: int = -1) -> bytes:
        self._check_not_closed()
        if self._writer is not None:
            raise io.UnsupportedOperation("not readable")
        if size is None or size < 0:
            self._fill(1 << 62)
            out = bytes(self._buf)
            self._buf = bytearray()
        else:
            self._fill(size)
            out = bytes(self._buf[:size])
            del self._buf[:size]
        self._size += len(out)
        return out

    def read1(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            size = io.DEFAULT_BUFFER_SIZE
        if not self._buf:
            self._fill(max(1, size))
        return self.read(min(size, max(len(self._buf), 1)))

    def peek(self, n: int = 1) -> bytes:
        self._check_not_closed()
        if self._writer is not None:
            raise io.UnsupportedOperation("not readable")
        self._fill(max(n, 1))
        return bytes(self._buf[:max(n, 1)])

    def rewind(self):
        """Return to the start of the uncompressed stream (read mode)."""
        self._check_not_closed()
        if self._writer is not None:
            raise io.UnsupportedOperation("Can't rewind in write mode")
        self._fileobj.seek(0)
        self._new_reader()
        self._size = 0

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        self._check_not_closed()
        if whence == io.SEEK_CUR:
            offset = self._size + offset
        elif whence == io.SEEK_END:
            if self._writer is not None:
                raise io.UnsupportedOperation(
                    "Seek from end not supported")
            self._fill(1 << 62)
            offset = self._size + len(self._buf) + offset
        elif whence != io.SEEK_SET:
            raise ValueError(f"Invalid whence: {whence}")
        if self._writer is not None:
            if offset < self._size:
                raise OSError("Negative seek in write mode")
            zeros = offset - self._size
            chunk = b"\0" * min(zeros, 1 << 20)
            while zeros > 0:
                take = min(zeros, len(chunk))
                self.write(chunk[:take])
                zeros -= take
            return self._size
        if offset < self._size:
            self.rewind()
        while self._size < offset:
            got = self.read(min(offset - self._size, 1 << 20))
            if not got:
                break
        return self._size

    # --- write side ---------------------------------------------------------

    def write(self, data) -> int:
        self._check_not_closed()
        if self._writer is None:
            raise io.UnsupportedOperation("not writable")
        data = bytes(data)
        out = self._writer.compress(data)
        if out:
            self._fileobj.write(out)
        self._size += len(data)
        return len(data)

    def flush(self):
        self._check_not_closed()
        if self._writer is not None:
            out = self._writer.sync_flush()
            if out:
                self._fileobj.write(out)
        if hasattr(self._fileobj, "flush"):
            self._fileobj.flush()

    # --- lifecycle ----------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self):
        if self._closed:
            return
        try:
            if self._writer is not None:
                self._fileobj.write(self._writer.flush())
        finally:
            self._closed = True
            if self.myfileobj is not None:
                self.myfileobj.close()
                self.myfileobj = None

    def fileno(self):
        return self._fileobj.fileno()


def open(filename, mode: str = "rb", compresslevel: int = 9,
         encoding=None, errors=None, newline=None):
    """Like stdlib gzip.open: binary modes return a GzipFile, text
    modes a TextIOWrapper around one."""
    if "t" in mode:
        if "b" in mode:
            raise ValueError(f"Invalid mode: {mode!r}")
    else:
        if encoding is not None:
            raise ValueError("Argument 'encoding' not supported in "
                             "binary mode")
        if errors is not None:
            raise ValueError("Argument 'errors' not supported in "
                             "binary mode")
        if newline is not None:
            raise ValueError("Argument 'newline' not supported in "
                             "binary mode")
    gz_mode = mode.replace("t", "")
    if isinstance(filename, (str, bytes, os.PathLike)):
        f = GzipFile(filename, gz_mode, compresslevel)
    elif hasattr(filename, "read") or hasattr(filename, "write"):
        f = GzipFile(None, gz_mode, compresslevel, filename)
    else:
        raise TypeError("filename must be a str or bytes object, "
                        "or a file")
    if "t" in mode:
        return io.TextIOWrapper(f, encoding, errors, newline)
    return f
