"""The plain reference: what each answer of a run should be.

It imports nothing of the program. It takes the data the benchmark made
from the seed and the payloads it made from them, never anything the
program made. The configuration's container format (formats/<format>.py)
says what a payload's checks must hold for its data (for gzip the CRC-32
and ISIZE in the trailer, RFC 1952; for zlib the Adler-32, RFC 1950),
computed from the data with stdlib zlib. A payload whose checks hold
them must be answered with exactly that data. A payload whose checks do
not must be rejected with a checksum error: the configuration's
guarantee that every check is verified.
"""

from __future__ import annotations

CHECKSUM_ERROR = "a checksum error"


class Reference:
    """The expected answer to each payload of one configuration."""

    def __init__(self, fmt, datas: list):
        """`fmt`: the module of the configuration's format (a Cell's
        `format`, or cells.format_module(name))."""
        self.fmt = fmt
        self.datas = datas
        self._checks: dict = {}

    def expect(self, f: int, payload: bytes):
        """File `f`'s data, or CHECKSUM_ERROR where `payload`'s checks
        do not hold the data's values."""
        if f not in self._checks:
            self._checks[f] = self.fmt.checks(self.datas[f])
        good = self.fmt.holds(payload, self._checks[f])
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
