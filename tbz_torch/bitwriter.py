"""LSB-first bit packer (inverse of bitreader; host encoder emission)."""

from __future__ import annotations


class BitWriter:
    __slots__ = ("buf", "nbits", "out")

    def __init__(self):
        self.buf = 0
        self.nbits = 0
        self.out = bytearray()

    def bits(self, value: int, n: int) -> None:
        self.buf |= (value & ((1 << n) - 1)) << self.nbits
        self.nbits += n
        while self.nbits >= 8:
            self.out.append(self.buf & 0xFF)
            self.buf >>= 8
            self.nbits -= 8

    def huff(self, code: int, n: int) -> None:
        """Huffman code: MSB-first on the wire."""
        rev = 0
        c = code
        for _ in range(n):
            rev = (rev << 1) | (c & 1)
            c >>= 1
        self.bits(rev, n)

    def align(self) -> None:
        if self.nbits:
            self.out.append(self.buf & 0xFF)
            self.buf = 0
            self.nbits = 0

    def raw_bytes(self, data: bytes) -> None:
        self.align()
        self.out += data

    def bit_length(self) -> int:
        return len(self.out) * 8 + self.nbits

    def bytes(self) -> bytes:
        b = bytearray(self.out)
        if self.nbits:
            b.append(self.buf & 0xFF)
        return bytes(b)
