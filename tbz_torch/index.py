"""Random access into compressed streams: a seek index of periodic
decoder checkpoints (the port of tbz/index.py; host code over
tbz_torch.streaming.Decompressor, as in tbz).

DEFLATE is sequential — byte N's meaning depends on every bit before
it — so random access needs saved decoder states (the bgzf /
indexed-gzip pattern). streaming.Decompressor's checkpoint blobs
already capture ALL mid-stream state (bit position, Huffman tables,
32KB window, framing progress; versioned TLV, no pickle), so an index
is just (output_offset, input_offset, blob) points taken every
`every` output bytes during one sequential pass. `read(start, size)`
then restores the nearest point and decodes forward at most `every`
bytes instead of the whole stream.

Reads decode in bounded mode, so peak memory is O(size + chunk), not
O(start). A read that stops before the stream end never sees the
trailer, so whole-stream checksums are NOT verified by read() — run
one full decompress (or build(), which decodes everything) when
integrity matters.

The index blob (magic TBZX\x01) and the checkpoint blobs inside it are
tbz's formats: an index serialized by either package loads and reads
in the other.
"""

from __future__ import annotations

import bisect
import dataclasses

from .errors import DeflateError
from .streaming import Decompressor

__all__ = ["SeekIndex"]

_MAGIC = b"TBZX\x01"
_CHUNK = 1 << 16


@dataclasses.dataclass
class _Point:
    out_off: int
    in_off: int
    blob: bytes


class SeekIndex:
    """Checkpoint index over one compressed stream (raw/zlib/gzip,
    multi-member gzip included).

    >>> idx = SeekIndex.build(payload, "gzip", every=4 << 20)
    >>> idx.read(payload, start=123_456_789, size=4096)
    """

    def __init__(self, points: list[_Point], total_out: int,
                 format: str):
        self.points = points
        self.total_out = total_out
        self.format = format
        self._outs = [p.out_off for p in points]

    # --- construction -------------------------------------------------------

    @classmethod
    def build(cls, payload, format: str = "auto",
              every: int = 4 << 20) -> "SeekIndex":
        """One sequential decode of `payload`, snapshotting the decoder
        whenever `every` more output bytes have been produced. Verifies
        checksums along the way (it sees the whole stream)."""
        payload = bytes(payload)
        if every < 1 << 16:
            every = 1 << 16
        d = Decompressor(format)
        points = [_Point(0, 0, d.checkpoint())]
        out_off = 0
        in_off = 0
        next_mark = every
        while in_off < len(payload):
            chunk = payload[in_off:in_off + _CHUNK]
            in_off += len(chunk)
            out_off += len(d.decompress(chunk))
            if out_off >= next_mark:
                points.append(_Point(out_off, in_off, d.checkpoint()))
                next_mark = out_off + every
        out_off += len(d.flush())
        fmt = d.format if format == "auto" else format
        return cls(points, out_off, fmt)

    # --- random access ------------------------------------------------------

    def read(self, payload, start: int, size: int) -> bytes:
        """Decode `size` bytes of decompressed content starting at
        offset `start`, restoring from the nearest checkpoint. Returns
        fewer bytes only when the stream ends first."""
        payload = bytes(payload)
        if size <= 0 or start >= self.total_out:
            return b""
        i = bisect.bisect_right(self._outs, start) - 1
        p = self.points[i]
        d = Decompressor.restore(p.blob)
        produced = p.out_off
        in_off = p.in_off
        end = min(start + size, self.total_out)
        parts = []
        flushed = False
        while produced < end:
            budget = min(1 << 20, end - produced)
            out = d.decompress(payload[in_off:in_off + _CHUNK],
                               max_length=budget)
            in_off = min(in_off + _CHUNK, len(payload))
            if not out:
                if in_off >= len(payload):
                    if flushed:
                        break  # stream genuinely ended early
                    out = d.flush()
                    flushed = True
                    if not out:
                        break
                else:
                    continue
            lo = max(start - produced, 0)
            hi = min(end - produced, len(out))
            if hi > lo:
                parts.append(out[lo:hi])
            produced += len(out)
        return b"".join(parts)

    # --- (de)serialization ---------------------------------------------------

    def serialize(self) -> bytes:
        """Compact self-describing blob (store it next to the payload)."""
        fmt_b = self.format.encode()
        head = (_MAGIC + len(fmt_b).to_bytes(1, "little") + fmt_b
                + self.total_out.to_bytes(8, "little")
                + len(self.points).to_bytes(4, "little"))
        body = []
        for p in self.points:
            body.append(p.out_off.to_bytes(8, "little")
                        + p.in_off.to_bytes(8, "little")
                        + len(p.blob).to_bytes(4, "little") + p.blob)
        return head + b"".join(body)

    @classmethod
    def load(cls, blob: bytes) -> "SeekIndex":
        blob = bytes(blob)
        if blob[:5] != _MAGIC:
            raise DeflateError("not a tbz seek index")
        fl = blob[5]
        pos = 6
        fmt = blob[pos:pos + fl].decode()
        pos += fl
        total_out = int.from_bytes(blob[pos:pos + 8], "little")
        pos += 8
        n = int.from_bytes(blob[pos:pos + 4], "little")
        pos += 4
        points = []
        for _ in range(n):
            if pos + 20 > len(blob):
                raise DeflateError("truncated seek index")
            oo = int.from_bytes(blob[pos:pos + 8], "little")
            io_ = int.from_bytes(blob[pos + 8:pos + 16], "little")
            bl = int.from_bytes(blob[pos + 16:pos + 20], "little")
            pos += 20
            if pos + bl > len(blob):
                raise DeflateError("truncated seek index")
            points.append(_Point(oo, io_, blob[pos:pos + bl]))
            pos += bl
        return cls(points, total_out, fmt)
