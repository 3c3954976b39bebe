"""tbz_torch — the PyTorch/CUDA port of `tbz`, the DEFLATE codec.

Same public decode call and error classes as `tbz`, running the fused
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
  formats/                           — zlib / gzip framing
  api                                — one-shot decompress (fetched or
                                       device_resident=True)
  parallel/shard                     — batched decode of independent
                                       streams on one card

`decompress` runs the device backend on `cuda` by default; pass
device="cpu" (plain PyTorch versions of the kernels) or backend="host".
"""

from .errors import ChecksumError, DeflateError, TruncatedError

__all__ = ["DeflateError", "ChecksumError", "TruncatedError", "decompress"]


def decompress(data, format: str = "auto", **kw):
    """Decompress a raw deflate / zlib / gzip stream (see api.decompress)."""
    from . import api
    return api.decompress(data, format, **kw)
