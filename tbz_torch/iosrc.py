"""Input sources — parity with the reference's L2 io layer.

The reference reads from octet vectors, binary streams, and raw mmap
pointers via monomorphized reader contexts (io-common.lisp,
io-mmap.lisp:21-54, io.lisp:108-128). Here the equivalents are (copied
from tbz/iosrc.py):

  open files                -> mmap (the octet-pointer context;
                               api.decompress_file)
  arbitrary binary streams  -> chunked reads feeding the streaming
                               Decompressor (api.decompress_stream;
                               %resync-file-stream's seek/resume is
                               subsumed by byte-granular resume)
"""

from __future__ import annotations

import mmap
import os


class MappedFile:
    """mmap-backed input (the octet-pointer context, io-mmap.lisp:21-54):
    the page cache backs the compressed bytes (api.decompress reads the
    view once into the bytes it decodes)."""

    def __init__(self, path: str | os.PathLike):
        self._f = open(path, "rb")
        try:
            self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # empty file
            self._mm = None

    def view(self) -> memoryview:
        if self._mm is None:
            return memoryview(b"")
        return memoryview(self._mm)

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def iter_stream(fileobj, chunk_size: int = 1 << 20):
    """Chunk iterator over a binary stream (the stream context role).

    Seekable streams get the reference's %resync-file-stream contract
    (io-common.lisp:60-63): the iterator tracks its own byte offset and
    re-seeks before every read, so a caller that moves the file
    position between pulls (e.g. to peek elsewhere) does not corrupt
    the decode. Unseekable streams are consumed as-is."""
    pos = None
    try:
        if fileobj.seekable():
            pos = fileobj.tell()
    except (AttributeError, OSError):
        pos = None
    while True:
        if pos is not None and fileobj.tell() != pos:
            fileobj.seek(pos)
        piece = fileobj.read(chunk_size)
        if not piece:
            return
        if pos is not None:
            pos += len(piece)
        yield piece
