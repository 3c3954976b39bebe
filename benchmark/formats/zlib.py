"""zlib (RFC 1950): one stream a file, as zlib writes it (no preset
dictionary). Its check is the stream's trailer: the Adler-32 of the
data."""

import zlib

TRAILER = 4


def write(data: bytes, level: int) -> bytes:
    """One stream of `data` at `level`."""
    co = zlib.compressobj(level, zlib.DEFLATED, 15)
    return co.compress(data) + co.flush()


def checks(data: bytes) -> bytes:
    """The trailer a stream of `data` ends with."""
    return zlib.adler32(data).to_bytes(4, "big")


def holds(payload: bytes, values: bytes) -> bool:
    """Whether `payload`'s trailer is `values` (what `checks` gave)."""
    return payload.endswith(values)


def probe(payload: bytes) -> bytes:
    """`payload` with the first byte of its trailer's Adler-32 flipped."""
    at = len(payload) - TRAILER
    return payload[:at] + bytes([payload[at] ^ 0xFF]) + payload[at + 1:]
