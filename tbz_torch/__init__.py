"""tbz_torch — the PyTorch/CUDA port of `tbz`, the DEFLATE codec.

Same public calls and error classes as `tbz`, running the fused
device decode on an NVIDIA Hopper card with hand-written CUDA kernels
(tbz_torch/csrc, built with nvcc at first use). It imports `torch`,
numpy and the standard library, and nothing of JAX or `tbz`.

Package layout (mirrors tbz):
  constants, huffman, errors, tape   — tables & spec core
  bitreader, reference, frontend     — host frontends (Python oracle,
                                       native C++ in native/)
  ops/                               — device kernels: flat tables, lane
                                       decode, stitch/compaction,
                                       splice + resolve (one tape or a
                                       batch of rows)
  checksums                          — CRC-32 / Adler-32 (host, device)
  _cuda, csrc/                       — nvcc build + ctypes binding
  api, streaming                     — one-shot decompress (fetched or
                                       device_resident=True), into a
                                       buffer, from a file; chunked
                                       streaming with checkpoints
  deflate_encode, lz77, huffman_encode, bitwriter — the encoder (host)
  iosrc                              — mmap'd files, stream chunks
  formats/                           — zlib / gzip / ZIP framing
  zlib_compat, gzip_compat           — stdlib zlib / gzip drop-ins
  index                              — SeekIndex: random access by
                                       checkpoints
  parallel/                          — batched decode of independent
                                       streams (host threads, or rows
                                       over a mesh), meshes, sharded
                                       checksums
  utils/                             — Config (TBZ_TORCH_* env),
                                       stage timers and torch.profiler
                                       traces (profiling)
  debug                              — block / token / table dumps
  __main__                           — `python -m tbz_torch`, the CLI

`decompress`, `decompress_file`, `ZipReader`, `zlib_compat.decompress`,
`parallel.host.decompress_many` and the CLI's `-d` run the device
backend on `cuda` by default; pass device="cpu" (`--device cpu`: plain
PyTorch versions of the kernels) or backend="host". `compress`,
`Compressor`, `Decompressor`, `decompress_stream`, `decompress_into`,
`ZipWriter`, `gzip_compat`, `SeekIndex`, the zlib_compat stream objects
and `compress_many` are host code, as in tbz.
"""

from .errors import ChecksumError, DeflateError, TruncatedError

__all__ = [
    "DeflateError", "ChecksumError", "TruncatedError",
    "decompress", "compress", "decompress_into", "decompress_file",
    "decompress_stream",
    "Decompressor", "Compressor", "ZipReader", "ZipWriter",
]


def __getattr__(name):
    # Lazy, so that `import tbz_torch` builds no kernel and loads no
    # native library.
    if name in ("decompress", "compress", "decompress_into",
                "decompress_file", "decompress_stream"):
        from . import api
        return getattr(api, name)
    if name in ("Decompressor", "Compressor"):
        from . import streaming
        return getattr(streaming, name)
    if name in ("ZipReader", "ZipWriter"):
        from .formats import zip_fmt
        return getattr(zip_fmt, name)
    raise AttributeError(name)
