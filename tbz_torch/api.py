"""One-shot API (the reference's L6, api.lisp:3-73), the port of
tbz/api.py: decompress, decompress_into, decompress_file,
decompress_stream and compress.

`decompress` auto-detects raw/zlib/gzip framing (or takes it
explicitly), decodes each member body on the device — the fused
pipeline of ops/fused for bodies of at least 64 KB, otherwise the
configured frontend (Config.frontend / TBZ_TORCH_FRONTEND) plus the flat
span resolver of ops/resolve_spans — verifies checksums, and handles
multi-member gzip. Fetched output is verified with host zlib (it is
already on the host), or with the device checksum kernels under
Config.device_checksums (TBZ_TORCH_DEVICE_CHECKSUMS=1);
device_resident=True keeps the output on the device and verifies it
there (checksums.py: only one scalar per member crosses).

Unlike tbz, whose default backend resolves on the host, the default here
is the device backend on `cuda`: with no card present that raises, it
never carries on on the CPU. Ask for the CPU with device="cpu" (the
kernels' plain PyTorch versions run there) or for the native host
inflate with backend="host" (or "auto", tbz's default, which means the
same there). decompress_file passes its keywords on to decompress, so it
takes the same choice. decompress_into runs on the native host inflate,
and compress and decompress_stream are host code, as in tbz.

With Config.profile (TBZ_TORCH_PROFILE=1) each stage is timed
(utils.profiling.stage) into utils.profiling.metrics under tbz's names
and byte counts: inflate.host, decode.fused (the fused route's eight
fused.* spans nested in it, ops/fused.py), tokenize, resolve.device,
verify.{crc32,adler32}.device (resident output), verify.{crc32,adler32}
(fetched output, on the host or, with device_checksums, on the device)
and compress.
"""

from __future__ import annotations

import dataclasses
import zlib as _zlib

import torch

from . import frontend as _frontend
from .errors import DeflateError, TruncatedError, ERR_HEADER, ERR_PLAN_DEPTH
from .formats import gzip_fmt, zlib_fmt
from .utils import profiling
from .utils.config import get_config

FUSED_MIN_BYTES = 65536  # smaller bodies: tokenize + flat span resolve


@dataclasses.dataclass
class MemberInfo:
    format: str                      # 'raw' | 'zlib' | 'gzip'
    header: object | None            # ZlibHeader / GzipHeader / None
    output_size: int
    consumed: int                    # input bytes consumed incl. trailer


@dataclasses.dataclass
class StreamInfo:
    format: str
    members: list
    consumed: int                    # total input bytes consumed
    unused_data: bytes               # trailing bytes past the stream


def detect_format(data: bytes) -> str:
    if len(data) >= 2 and data[0] == 0x1F and data[1] == 0x8B:
        return "gzip"
    if (len(data) >= 2 and (data[0] & 0x0F) == 8 and (data[0] >> 4) <= 7
            and ((data[0] << 8) | data[1]) % 31 == 0):
        return "zlib"
    return "raw"


def _decode_body(body: bytes, window: bytes, backend: str,
                 device: torch.device | None, size_hint: int = 0,
                 fetch: bool = True):
    """One member's deflate body ->
    (out_bytes_or_None, total, end_bit, finished, body_dev).

    Host backend: the native single-pass inflate (or the Python oracle);
    body_dev is None. Device backend, as tbz/api.py:91-136: the fused
    pipeline when the configured frontend is 'auto' or 'device'; for the
    bodies it declines (under 64 KB, or no dynamic-block candidates:
    stored/static-only) or any other frontend, the configured frontend
    tokenizes and the flat span resolver resolves on the device, with
    pointer doubling only for outputs of 2 GB and more or a plan-depth
    error. Every device decode ends on the device, with the output in
    body_dev[:total]; fetch=False leaves it there (out is None). A native
    library that did not build raises here; the device backend has no
    Python fallback."""
    if backend in ("host", "auto"):
        from .native import loader
        if loader.available():
            with profiling.stage("inflate.host", len(body)):
                out, end_bit, fin = loader.inflate(body, window=window,
                                                   size_hint=size_hint)
            return out, len(out), end_bit, fin, None
        from . import reference
        res = reference.tokenize_host(body, 0, window_len=len(window))
        out = reference.resolve_host(res.tape, body, window)
        return out, len(out), res.end_bit, res.finished, None
    frontend = get_config().frontend
    if frontend in ("auto", "device") and len(body) >= FUSED_MIN_BYTES:
        from .ops import fused as _fused
        with profiling.stage("decode.fused", len(body), device):
            r = _fused.decode_stream_fused(body, window, fetch=fetch,
                                           device=device)
        if r is not None:
            out, body_dev, total, end_bit = r
            return out, int(total), end_bit, True, body_dev
    with profiling.stage("tokenize", len(body), device):
        res = _frontend.tokenize(body, 0, window_len=len(window),
                                 frontend=frontend, device=device)
    with profiling.stage("resolve.device", res.tape.total_out, device):
        try:
            from .ops import resolve_spans as _rs
            body_dev, total = _rs.resolve_flat_device(res.tape, body,
                                                      window, device=device)
        except (ValueError, DeflateError) as e:
            # >= 2 GB (int32 table addresses) or a pathological genealogy
            if isinstance(e, DeflateError) and e.code != ERR_PLAN_DEPTH:
                raise
            from .ops import resolve as _r
            out_dev, total = _r.resolve_device(res.tape, body, window,
                                               device=device)
            body_dev = out_dev[_r.W:]
    out = body_dev[:total].cpu().numpy().tobytes() if fetch else None
    return out, int(total), res.end_bit, res.finished, body_dev


def _verify_device(kind: str, body_dev, total: int, prev: int,
                   stage: str) -> int:
    """Checksum of body_dev[:total] on its device (only the scalar
    crosses). The stage holds the checksum module's first import too."""
    with profiling.stage(stage, total, body_dev.device):
        from . import checksums as cs
        if kind == "crc32":
            return cs.crc32_device_tail(body_dev, total, prev)
        return cs.adler32_device_tail(body_dev, total, prev)


def _verify_device_or_host(kind: str, body_dev, out: bytes | None,
                           total: int, prev: int) -> int:
    """Checksum of one member's output. Device-resident output (out is
    None) is verified on the device; fetched output with host zlib (it
    is already on the host), or, with Config.device_checksums, on the
    device wherever the decode left it there (as tbz/api.py:155-163; the
    host backend leaves no body_dev). Stage names are tbz's."""
    if out is None:
        return _verify_device(kind, body_dev, total, prev,
                              f"verify.{kind}.device")
    if body_dev is not None and get_config().device_checksums:
        return _verify_device(kind, body_dev, total, prev, f"verify.{kind}")
    with profiling.stage(f"verify.{kind}", len(out)):
        if kind == "crc32":
            return _zlib.crc32(out, prev)
        return _zlib.adler32(out, prev)


def _device_for(backend: str, device) -> torch.device | None:
    if backend in ("host", "auto"):
        return None
    if backend != "device":
        raise ValueError(f"unknown backend {backend!r}")
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tbz_torch: device backend needs a CUDA device; "
                           "pass device='cpu' or backend='host'")
    return device


def decompress(data, format: str = "auto", *, backend: str | None = None,
               zdict: bytes = b"", verify: bool = True,
               output_size: int | None = None,
               multi_member: bool = True, with_info: bool = False,
               device=None, device_resident: bool = False):
    """Decompress a raw deflate / zlib / gzip byte stream.

    backend: 'device' | 'host' | 'auto' (None reads Config.backend,
    default 'device'); 'auto' is tbz's default and means what it means
    there: the native host inflate, as 'host'. device: the torch device
    of the device backend (default 'cuda'). output_size: the declared
    output size, checked.
    device_resident: return the output as a uint8 tensor on the device
    instead of host bytes; checksums are verified there, so only the
    decode's metadata and error word and one checksum scalar per member
    cross to the host (none with verify=False). Multi-member gzip is
    concatenated on the device. Needs the device backend."""
    if device_resident:
        if backend not in (None, "device"):
            raise ValueError("device_resident requires the device backend")
        backend = "device"
    data = bytes(data)
    if backend is None:
        backend = get_config().backend
    dev = _device_for(backend, device)
    fmt = detect_format(data) if format == "auto" else format
    members: list[MemberInfo] = []
    parts: list = []
    fetch = not device_resident
    pos = 0

    if fmt == "raw":
        # Raw streams take a preset dictionary unconditionally
        # (zlib.decompressobj(-15, zdict=...) semantics).
        out, total, end_bit, finished, body_dev = _decode_body(
            data, zdict[-32768:], backend, dev, output_size or 0, fetch)
        if not finished:
            raise TruncatedError("deflate stream has no final block")
        if output_size is not None and total != output_size:
            raise DeflateError(
                f"output size {total} != declared {output_size}")
        consumed = (end_bit + 7) // 8
        members.append(MemberInfo("raw", None, total, consumed))
        parts.append(out if fetch else body_dev[:total])
        pos = consumed
    elif fmt == "zlib":
        hdr = zlib_fmt.parse_header(data, zdict)
        body = data[hdr.data_offset:]
        # RFC 1950: the dictionary is applied only when the header's
        # FDICT flag requests it.
        window = zdict[-32768:] if hdr.fdict else b""
        out, total, end_bit, finished, body_dev = _decode_body(
            body, window, backend, dev, output_size or 0, fetch)
        if not finished:
            raise TruncatedError("zlib deflate body truncated")
        end = hdr.data_offset + (end_bit + 7) // 8
        stored = zlib_fmt.read_trailer(data, end)
        if verify:
            # RFC 1950: the Adler covers the uncompressed data only
            zlib_fmt.check_adler(stored, _verify_device_or_host(
                "adler32", body_dev, out, total, 1))
        pos = end + 4
        members.append(MemberInfo("zlib", hdr, total, pos))
        parts.append(out if fetch else body_dev[:total])
    elif fmt == "gzip":
        while True:
            hdr = gzip_fmt.parse_header(data, pos)
            body = data[hdr.data_offset:]
            out, total, end_bit, finished, body_dev = _decode_body(
                body, b"", backend, dev, 0, fetch)
            if not finished:
                raise TruncatedError("gzip deflate body truncated")
            end = hdr.data_offset + (end_bit + 7) // 8
            crc, isize = gzip_fmt.read_trailer(data, end)
            if verify:
                gzip_fmt.check_trailer(crc, _verify_device_or_host(
                    "crc32", body_dev, out, total, 0), isize, total)
            member_end = end + 8
            members.append(MemberInfo("gzip", hdr, total,
                                      member_end - pos))
            parts.append(out if fetch else body_dev[:total])
            pos = member_end
            if not multi_member:
                break
            if pos + 2 > len(data) or data[pos] != 0x1F or data[pos + 1] != 0x8B:
                break
    else:
        raise DeflateError(f"unknown format {fmt!r}", ERR_HEADER)

    if device_resident:
        result = parts[0] if len(parts) == 1 else torch.cat(parts)
    else:
        result = b"".join(parts)
    total_len = sum(m.output_size for m in members)
    if output_size is not None and fmt != "raw" and total_len != output_size:
        raise DeflateError(
            f"output size {total_len} != declared {output_size}")
    if with_info:
        return result, StreamInfo(fmt, members, pos, data[pos:])
    return result


def decompress_into(data, out, format: str = "auto", *,
                    zdict: bytes = b"", verify: bool = True) -> int:
    """Decompress into a caller-provided writable buffer (bytearray,
    writable memoryview, or uint8 ndarray), zero-copy on the native
    host inflate — the reference's known-size fast path
    (api.lisp:36-48). Returns the number of bytes written. Raises
    DeflateError if the buffer is too small, and the native library's
    build error if it did not build. Bytes past the written length are
    unspecified (the fast copy loop keeps word-granular slack inside the
    buffer)."""
    from .native import loader
    data = bytes(data)
    fmt = detect_format(data) if format == "auto" else format
    mv = memoryview(out)
    if mv.readonly:
        raise TypeError("output buffer must be writable")
    mv = mv.cast("B")
    loader.require()

    if fmt == "raw":
        n, end_bit, fin = loader.inflate_into(data, mv,
                                              window=zdict[-32768:])
        if not fin:
            raise TruncatedError("deflate stream has no final block")
        return n
    if fmt == "zlib":
        hdr = zlib_fmt.parse_header(data, zdict)
        body = data[hdr.data_offset:]
        window = zdict[-32768:] if hdr.fdict else b""
        n, end_bit, fin = loader.inflate_into(body, mv, window=window)
        if not fin:
            raise TruncatedError("zlib deflate body truncated")
        if verify:
            stored = zlib_fmt.read_trailer(data, hdr.data_offset
                                           + (end_bit + 7) // 8)
            zlib_fmt.check_adler(stored, _zlib.adler32(mv[:n]))
        return n
    # gzip, possibly multi-member
    pos = 0       # input offset
    wrote = 0     # output offset
    while True:
        hdr = gzip_fmt.parse_header(data, pos)
        body = data[hdr.data_offset:]
        n, end_bit, fin = loader.inflate_into(body, mv[wrote:])
        if not fin:
            raise TruncatedError("gzip deflate body truncated")
        end = hdr.data_offset + (end_bit + 7) // 8
        crc, isize = gzip_fmt.read_trailer(data, end)
        if verify:
            gzip_fmt.check_trailer(crc, _zlib.crc32(mv[wrote:wrote + n]),
                                   isize, n)
        wrote += n
        pos = end + 8
        if pos + 2 > len(data) or data[pos:pos + 2] != b"\x1f\x8b":
            return wrote


def compress(data, format: str = "zlib", level: int | None = None, **kw):
    """Compress to raw / zlib / gzip framing on the host (level None
    reads Config.level / TBZ_TORCH_LEVEL). Extra keywords pass through
    to the encoder: threads= (segment-parallel), zdict= (preset
    dictionary, raw/zlib), mtime=/name=/extra= (gzip header fields)."""
    from . import deflate_encode
    if level is None:
        level = get_config().level
    with profiling.stage("compress", len(data)):
        return deflate_encode.compress(data, format=format, level=level,
                                       **kw)


def decompress_file(path, format: str = "auto", **kw) -> bytes:
    """Decompress a file through mmap (the reference's octet-pointer
    path, io-mmap.lisp / with-octet-pointer). Keywords pass through to
    decompress (backend=, device=, device_resident=, ...), which reads
    the mapped view once into the bytes it decodes."""
    from .iosrc import MappedFile
    with MappedFile(path) as mf:
        view = mf.view()
        try:
            return decompress(view, format, **kw)
        finally:
            view.release()


def decompress_stream(fileobj, format: str = "auto",
                      chunk_size: int = 1 << 20, zdict: bytes = b""):
    """Generator of decompressed chunks from a binary stream (the
    stream-context role, io.lisp:61-104), through the host streaming
    Decompressor."""
    from .iosrc import iter_stream
    from .streaming import Decompressor
    d = Decompressor(format, zdict=zdict)
    for piece in iter_stream(fileobj, chunk_size):
        out = d.decompress(piece)
        if out:
            yield out
    d.flush()
