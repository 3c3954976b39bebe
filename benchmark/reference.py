"""The plain reference: what each answer of a run should be.

It imports nothing of the program. It takes the data the benchmark made
from the seed and the compressed payloads it made from them, never
anything the program made. A payload whose trailer holds the checksum
of its data (CRC-32 and ISIZE for gzip, RFC 1952; Adler-32 for zlib,
RFC 1950; computed here from the data with stdlib zlib) must be
answered with exactly that data. A payload whose trailer does not must
be rejected with a checksum error: the configuration's guarantee that
every trailer is verified.
"""

from __future__ import annotations

import zlib


def checksum(fmt: str, data: bytes) -> bytes:
    """The trailer `fmt` ends a member of `data` with."""
    if fmt == "gzip":
        return ((zlib.crc32(data) & 0xFFFFFFFF).to_bytes(4, "little")
                + (len(data) & 0xFFFFFFFF).to_bytes(4, "little"))
    if fmt == "zlib":
        return zlib.adler32(data).to_bytes(4, "big")
    raise ValueError(f"no trailer in format {fmt!r}")


def break_trailer(fmt: str, payload: bytes) -> bytes:
    """`payload` with the first byte of its trailer's checksum flipped."""
    at = len(payload) - len(checksum(fmt, b""))
    return payload[:at] + bytes([payload[at] ^ 0xFF]) + payload[at + 1:]


CHECKSUM_ERROR = "a checksum error"


class Reference:
    """The expected answer to each payload of one configuration."""

    def __init__(self, fmt: str, datas: list):
        self.fmt = fmt
        self.datas = datas
        self._trailers: dict = {}

    def expect(self, f: int, payload: bytes):
        """File `f`'s data, or CHECKSUM_ERROR where `payload`'s trailer
        does not hold the data's checksum."""
        if f not in self._trailers:
            self._trailers[f] = checksum(self.fmt, self.datas[f])
        good = payload.endswith(self._trailers[f])
        return self.datas[f] if good else CHECKSUM_ERROR


def is_checksum_error(answer) -> bool:
    return isinstance(answer, BaseException) and any(
        c.__name__ == "ChecksumError" for c in type(answer).__mro__)


def agrees(expected, answer) -> bool:
    """Whether `answer` (bytes, or the exception a call raised or
    returned) is the expected one."""
    if expected is CHECKSUM_ERROR:
        return is_checksum_error(answer)
    return isinstance(answer, (bytes, bytearray)) and answer == expected
