"""BGZF, the blocked gzip of the SAM/BAM specification (SAMv1 §4.1;
htslib bgzf.c): a file is a series of gzip members, each of at most
65,280 bytes of data (BGZF_BLOCK_SIZE 0xff00), as htslib writes them
(MTIME 0, XFL 0, OS 255, XLEN 6 holding the subfield BC: SI1 66, SI2
67, SLEN 2, and BSIZE, the member's size less 1), then the fixed
28-byte empty EOF block. Its checks are every member's trailer: the
CRC-32 and ISIZE of its block of data."""

import concurrent.futures
import os
import zlib

BLOCK = 0xFF00
TRAILER = 8
# a member's header up to its BSIZE
HEAD = bytes.fromhex("1f8b08040000000000ff0600") + b"BC\x02\x00"
EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b00"
                    "03000000000000000000")


def _blocks(data: bytes) -> list:
    return [data[i:i + BLOCK] for i in range(0, len(data), BLOCK)]


def _trailer(block: bytes) -> bytes:
    return ((zlib.crc32(block) & 0xFFFFFFFF).to_bytes(4, "little")
            + len(block).to_bytes(4, "little"))


def _ends(payload: bytes) -> list:
    """Each member's end, read from its BSIZE."""
    ends, at = [], 0
    while at < len(payload):
        xlen = int.from_bytes(payload[at + 10:at + 12], "little")
        extra, k, bsize = payload[at + 12:at + 12 + xlen], 0, None
        while k + 4 <= len(extra):
            n = int.from_bytes(extra[k + 2:k + 4], "little")
            if extra[k:k + 2] == b"BC" and n == 2:
                bsize = int.from_bytes(extra[k + 4:k + 6], "little")
            k += 4 + n
        if bsize is None:
            raise ValueError(f"the member at {at} holds no BC subfield")
        at += bsize + 1
        ends.append(at)
    return ends


def _member(block: bytes, level: int) -> bytes:
    body = zlib.compress(block, level, -15)
    bsize = len(HEAD) + 2 + len(body) + TRAILER - 1
    return HEAD + bsize.to_bytes(2, "little") + body + _trailer(block)


def write(data: bytes, level: int) -> bytes:
    """`data` in blocks of 65,280 bytes, each a member at `level`, then
    the EOF block. The blocks are compressed in threads (zlib lets go of
    the GIL), as a BGZF writer can."""
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        members = list(pool.map(_member, _blocks(data),
                                [level] * -(-len(data) // BLOCK)))
    return b"".join(members) + EOF


def checks(data: bytes) -> bytes:
    """The trailers of a file of `data`, in order, the EOF block's last."""
    return b"".join(_trailer(b) for b in _blocks(data)) + EOF[-TRAILER:]


def holds(payload: bytes, values: bytes) -> bool:
    """Whether `payload`'s trailers are `values` (what `checks` gave)."""
    return b"".join(payload[e - TRAILER:e] for e in _ends(payload)) == values


def probe(payload: bytes) -> bytes:
    """`payload` with the first byte of its middle member's CRC-32
    flipped (the first of two), so that its detection does not rest on
    the last member."""
    ends = _ends(payload)
    at = ends[(len(ends) - 1) // 2] - TRAILER
    return payload[:at] + bytes([payload[at] ^ 0xFF]) + payload[at + 1:]
