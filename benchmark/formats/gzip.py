"""gzip (RFC 1952): one member a file, as `gzip -N` writes it (no name,
mtime 0). Its check is the member's trailer: the CRC-32 and ISIZE of
the data."""

import zlib

TRAILER = 8


def write(data: bytes, level: int) -> bytes:
    """One member of `data` at `level`."""
    co = zlib.compressobj(level, zlib.DEFLATED, 31)
    return co.compress(data) + co.flush()


def checks(data: bytes) -> bytes:
    """The trailer a member of `data` ends with."""
    return ((zlib.crc32(data) & 0xFFFFFFFF).to_bytes(4, "little")
            + (len(data) & 0xFFFFFFFF).to_bytes(4, "little"))


def holds(payload: bytes, values: bytes) -> bool:
    """Whether `payload`'s trailer is `values` (what `checks` gave)."""
    return payload.endswith(values)


def probe(payload: bytes) -> bytes:
    """`payload` with the first byte of its trailer's CRC-32 flipped."""
    at = len(payload) - TRAILER
    return payload[:at] + bytes([payload[at] ^ 0xFF]) + payload[at + 1:]
