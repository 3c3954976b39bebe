"""ZIP container reader (central-directory driven).

Beyond the reference (which has no container formats): ZIP archives are
the most common carrier of raw-deflate streams, so the codec exposes a
reader that walks the central directory and inflates members through
api.decompress (stored and deflate methods), verifying each member's
CRC-32: on the device backend by default, as the port's decompress, or
with backend="host"/"auto" on the native host inflate, two members at a
time in read_all. This is tbz/formats/zip_fmt.py's copy, with the
device choice added.

ZIP64 is supported on read (EOCD64 record + 0x0001 extended fields)
and on write (emitted only when counts/sizes/offsets need it, or when
forced per entry). Not supported (raises DeflateError): encryption,
compression methods other than stored/deflate, spanned archives.
"""

from __future__ import annotations

import dataclasses
import zlib as _zlib

from ..errors import ChecksumError, DeflateError, ERR_CHECKSUM, ERR_HEADER
from ..native import loader
from ..utils.config import get_config

_EOCD_SIG = b"PK\x05\x06"
_EOCD64_SIG = b"PK\x06\x06"
_EOCD64_LOC_SIG = b"PK\x06\x07"
_CDIR_SIG = b"PK\x01\x02"
_LOCAL_SIG = b"PK\x03\x04"


@dataclasses.dataclass
class ZipEntry:
    name: str
    method: int              # 0 stored | 8 deflate
    crc32: int
    compressed_size: int
    uncompressed_size: int
    local_offset: int
    flags: int
    comment: bytes = b""


def _find_eocd(data: bytes) -> int:
    # EOCD is 22 bytes + up to 64KB of archive comment.
    lo = max(0, len(data) - (1 << 16) - 22)
    idx = data.rfind(_EOCD_SIG, lo)
    if idx < 0:
        raise DeflateError("zip: end-of-central-directory not found",
                           ERR_HEADER)
    return idx


def _zip64_eocd(data: bytes, eocd: int):
    """ZIP64: the EOCD64 locator sits immediately before the EOCD and
    points at the EOCD64 record carrying the 64-bit count/size/offset."""
    loc = eocd - 20
    if loc < 0 or data[loc:loc + 4] != _EOCD64_LOC_SIG:
        raise DeflateError("zip64 EOCD locator missing", ERR_HEADER)
    rec = int.from_bytes(data[loc + 8:loc + 16], "little")
    if data[rec:rec + 4] != _EOCD64_SIG:
        raise DeflateError("zip64 EOCD record missing", ERR_HEADER)
    n_total = int.from_bytes(data[rec + 32:rec + 40], "little")
    cd_size = int.from_bytes(data[rec + 40:rec + 48], "little")
    cd_off = int.from_bytes(data[rec + 48:rec + 56], "little")
    return n_total, cd_size, cd_off


def _zip64_fields(extra: bytes, usize: int, csize: int, loff: int):
    """Resolve 0xFFFFFFFF sentinels from the 0x0001 extended-info extra
    field (values appear in order, only for the sentinel'd fields)."""
    pos = 0
    while pos + 4 <= len(extra):
        tag = int.from_bytes(extra[pos:pos + 2], "little")
        size = int.from_bytes(extra[pos + 2:pos + 4], "little")
        body = extra[pos + 4:pos + 4 + size]
        if tag == 0x0001:
            b = 0
            if usize == 0xFFFFFFFF:
                usize = int.from_bytes(body[b:b + 8], "little")
                b += 8
            if csize == 0xFFFFFFFF:
                csize = int.from_bytes(body[b:b + 8], "little")
                b += 8
            if loff == 0xFFFFFFFF:
                loff = int.from_bytes(body[b:b + 8], "little")
                b += 8
            return usize, csize, loff
        pos += 4 + size
    raise DeflateError("zip64 sizes without a 0x0001 extra field",
                       ERR_HEADER)


def parse_directory(data: bytes) -> list[ZipEntry]:
    eocd = _find_eocd(data)
    if len(data) - eocd < 22:
        raise DeflateError("zip: EOCD truncated", ERR_HEADER)
    n_total = int.from_bytes(data[eocd + 10:eocd + 12], "little")
    cd_size = int.from_bytes(data[eocd + 12:eocd + 16], "little")
    cd_off = int.from_bytes(data[eocd + 16:eocd + 20], "little")
    if (n_total == 0xFFFF or cd_size == 0xFFFFFFFF
            or cd_off == 0xFFFFFFFF):
        n_total, cd_size, cd_off = _zip64_eocd(data, eocd)
    entries = []
    pos = cd_off
    for _ in range(n_total):
        if data[pos:pos + 4] != _CDIR_SIG:
            raise DeflateError("zip: bad central directory entry",
                               ERR_HEADER)
        flags = int.from_bytes(data[pos + 8:pos + 10], "little")
        method = int.from_bytes(data[pos + 10:pos + 12], "little")
        crc = int.from_bytes(data[pos + 16:pos + 20], "little")
        csize = int.from_bytes(data[pos + 20:pos + 24], "little")
        usize = int.from_bytes(data[pos + 24:pos + 28], "little")
        nlen = int.from_bytes(data[pos + 28:pos + 30], "little")
        xlen = int.from_bytes(data[pos + 30:pos + 32], "little")
        clen = int.from_bytes(data[pos + 32:pos + 34], "little")
        loff = int.from_bytes(data[pos + 42:pos + 46], "little")
        name_raw = data[pos + 46:pos + 46 + nlen]
        name = (name_raw.decode("utf-8") if flags & 0x800
                else name_raw.decode("cp437"))
        comment = data[pos + 46 + nlen + xlen:pos + 46 + nlen + xlen + clen]
        if (csize == 0xFFFFFFFF or usize == 0xFFFFFFFF
                or loff == 0xFFFFFFFF):
            extra = data[pos + 46 + nlen:pos + 46 + nlen + xlen]
            usize, csize, loff = _zip64_fields(extra, usize, csize, loff)
        if flags & 0x01:
            raise DeflateError("encrypted zip members not supported",
                               ERR_HEADER)
        entries.append(ZipEntry(name=name, method=method, crc32=crc,
                                compressed_size=csize,
                                uncompressed_size=usize,
                                local_offset=loff, flags=flags,
                                comment=bytes(comment)))
        pos += 46 + nlen + xlen + clen
    if pos != cd_off + cd_size:
        raise DeflateError("zip: central directory size mismatch",
                           ERR_HEADER)
    return entries


def _member_body(data: bytes, e: ZipEntry) -> bytes:
    pos = e.local_offset
    if data[pos:pos + 4] != _LOCAL_SIG:
        raise DeflateError("zip: bad local header", ERR_HEADER)
    nlen = int.from_bytes(data[pos + 26:pos + 28], "little")
    xlen = int.from_bytes(data[pos + 28:pos + 30], "little")
    start = pos + 30 + nlen + xlen
    return data[start:start + e.compressed_size]


class ZipReader:
    """Read-only ZIP archive over a bytes-like object.

    >>> zr = ZipReader(blob)
    >>> zr.names()
    >>> zr.read("path/in/archive.txt")
    """

    def __init__(self, data, *, backend: str | None = None, device=None):
        """backend and device as api.decompress takes them (None: the
        configured backend, the device by default; device: the torch
        device of the device backend, 'cuda' by default)."""
        self._data = bytes(data)
        self._backend = backend
        self._device = device
        self.entries = parse_directory(self._data)
        # like stdlib zipfile, duplicate names keep every entry in
        # entries/infolist(); by-name lookup resolves to the LAST one
        # (zipfile.NameToInfo semantics)
        self._by_name = {e.name: e for e in self.entries}

    def names(self) -> list[str]:
        return [e.name for e in self.entries]

    def infolist(self) -> list[ZipEntry]:
        return list(self.entries)

    def read(self, name: str, verify: bool = True) -> bytes:
        try:
            e = self._by_name[name]
        except KeyError:
            raise KeyError(
                f"there is no item named {name!r} in the archive") from None
        return self._read_entry(e, name, verify)

    def _read_entry(self, e: ZipEntry, name: str, verify: bool) -> bytes:
        body = _member_body(self._data, e)
        if e.method == 0:
            out = body
        elif e.method == 8:
            from .. import api
            out = api.decompress(body, "raw", backend=self._backend,
                                 device=self._device, verify=False,
                                 output_size=e.uncompressed_size)
        else:
            raise DeflateError(
                f"zip compression method {e.method} not supported",
                ERR_HEADER)
        return self._finish_entry(e, name, out, verify)

    def _finish_entry(self, e: ZipEntry, name: str, out: bytes,
                      verify: bool) -> bytes:
        if len(out) != e.uncompressed_size:
            raise DeflateError(
                f"zip member size {len(out)} != directory "
                f"{e.uncompressed_size}")
        if verify and _zlib.crc32(out) != e.crc32:
            raise ChecksumError(
                f"zip member {name!r} CRC-32 mismatch", ERR_CHECKSUM)
        return out

    def read_all(self, verify: bool = True) -> dict[str, bytes]:
        """Decode every entry. Duplicate names collapse to the LAST
        entry's content in the dict (matching by-name lookup); use
        infolist() + _read_entry-via-read for positional access.

        On the host backend ('host' or 'auto'), deflate entries decode
        two at a time through the native paired inflate
        (loader.inflate_pair) when available — archives are the natural
        many-independent-streams case it was built for; a malformed entry
        falls back to the single-stream decoder inside the wrapper, so
        error behavior matches read(). On the device backend each entry
        decodes on the device, as read() does."""
        backend = self._backend or get_config().backend
        use_pair = backend in ("host", "auto") and loader.available()
        results: dict[int, bytes] = {}
        defl = [i for i, e in enumerate(self.entries)
                if e.method == 8] if use_pair else []
        for a, b in zip(defl[0::2], defl[1::2]):
            ea, eb = self.entries[a], self.entries[b]
            oa, ob = loader.inflate_pair(
                _member_body(self._data, ea), _member_body(self._data, eb),
                ea.uncompressed_size, eb.uncompressed_size)
            results[a] = self._finish_entry(ea, ea.name, oa, verify)
            results[b] = self._finish_entry(eb, eb.name, ob, verify)
        return {e.name: (results[i] if i in results else
                         self._read_entry(e, e.name, verify))
                for i, e in enumerate(self.entries)}


class ZipWriter:
    """Minimal ZIP writer (APPNOTE 4.4.x subset matching ZipReader):
    local file headers + central directory + EOCD, method 8 (deflate,
    via deflate_encode) or 0 (stored). ZIP64 records are emitted
    exactly when counts/sizes/offsets need them (or per entry with
    force_zip64, mirroring zipfile's flag).

    Usage:
        w = ZipWriter()
        w.write("a.txt", b"hello", level=9)
        blob = w.getvalue()          # round-trips through ZipReader
    """

    def __init__(self):
        self._parts: list[bytes] = []
        self._central: list[bytes] = []
        self._offset = 0
        self._count = 0

    def write(self, name: str, data: bytes, level: int = 6,
              method: int | None = None,
              force_zip64: bool = False) -> None:
        from .. import deflate_encode as de
        data = bytes(data)
        name_b = name.encode("utf-8")
        crc = _zlib.crc32(data)
        if method is None:
            method = 8 if level > 0 and len(data) > 32 else 0
        if method == 8:
            body = de.deflate_raw(data, max(level, 1))
            if len(body) >= len(data):
                method, body = 0, data
        elif method == 0:
            body = data
        else:
            raise ValueError(f"unsupported zip method {method}")
        zip64 = (force_zip64
                 or max(len(body), len(data)) >= 0xFFFFFFFF
                 or self._offset >= 0xFFFFFFFF)
        # general-purpose flag bit 11: UTF-8 names
        flags = 0x0800
        version = 45 if zip64 else 20
        if zip64:
            l_csize = l_usize = 0xFFFFFFFF
            l_extra = (b"\x01\x00" + (16).to_bytes(2, "little")
                       + len(data).to_bytes(8, "little")
                       + len(body).to_bytes(8, "little"))
            c_extra = (b"\x01\x00" + (24).to_bytes(2, "little")
                       + len(data).to_bytes(8, "little")
                       + len(body).to_bytes(8, "little")
                       + self._offset.to_bytes(8, "little"))
            c_loff = 0xFFFFFFFF
        else:
            l_csize, l_usize = len(body), len(data)
            l_extra = c_extra = b""
            c_loff = self._offset
        fixed = (b"PK\x03\x04" + version.to_bytes(2, "little")
                 + flags.to_bytes(2, "little")
                 + method.to_bytes(2, "little")
                 + b"\x00\x00\x00\x00"  # dos time/date (zeroed)
                 + crc.to_bytes(4, "little")
                 + l_csize.to_bytes(4, "little")
                 + l_usize.to_bytes(4, "little")
                 + len(name_b).to_bytes(2, "little")
                 + len(l_extra).to_bytes(2, "little"))
        self._parts.append(fixed + name_b + l_extra + body)
        self._central.append(
            b"PK\x01\x02" + version.to_bytes(2, "little") * 2
            + flags.to_bytes(2, "little")
            + method.to_bytes(2, "little")
            + b"\x00\x00\x00\x00"
            + crc.to_bytes(4, "little")
            + l_csize.to_bytes(4, "little")
            + l_usize.to_bytes(4, "little")
            + len(name_b).to_bytes(2, "little")
            + len(c_extra).to_bytes(2, "little")
            + b"\x00\x00" * 2  # comment len, disk#
            + b"\x00\x00"      # internal attrs
            + b"\x00\x00\x00\x00"  # external attrs
            + c_loff.to_bytes(4, "little")
            + name_b + c_extra)
        self._offset += len(fixed) + len(name_b) + len(l_extra) \
            + len(body)
        self._count += 1

    def getvalue(self) -> bytes:
        cd = b"".join(self._central)
        cd_off = self._offset
        need64 = (self._count >= 0xFFFF or len(cd) >= 0xFFFFFFFF
                  or cd_off >= 0xFFFFFFFF)
        tail = b""
        if need64:
            eocd64 = (_EOCD64_SIG
                      + (44).to_bytes(8, "little")  # record size - 12
                      + (45).to_bytes(2, "little") * 2
                      + b"\x00" * 8                 # disk numbers
                      + self._count.to_bytes(8, "little") * 2
                      + len(cd).to_bytes(8, "little")
                      + cd_off.to_bytes(8, "little"))
            locator = (_EOCD64_LOC_SIG + b"\x00" * 4
                       + (cd_off + len(cd)).to_bytes(8, "little")
                       + (1).to_bytes(4, "little"))
            tail = eocd64 + locator
        eocd = (b"PK\x05\x06" + b"\x00\x00" * 2
                + min(self._count, 0xFFFF).to_bytes(2, "little") * 2
                + min(len(cd), 0xFFFFFFFF).to_bytes(4, "little")
                + min(cd_off, 0xFFFFFFFF).to_bytes(4, "little")
                + b"\x00\x00")
        return b"".join(self._parts) + cd + tail + eocd
