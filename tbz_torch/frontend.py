"""Frontend dispatcher: bit stream -> token tape.

Interchangeable frontends with one contract, as tbz/frontend.py:
  - 'native' : the C++ tokenizer (tbz_torch/native), the host fast path;
               'auto' takes it too, and raises its build error if it did
               not build (the device decode has no Python fallback);
  - 'python' : tbz_torch.reference, the bit-exact oracle;
  - 'device' : the device tokenizers (ops/tokenize_device.tokenize_auto):
               the sequential machine under 64 KB, the batched and
               per-block speculative lane decoders above, on `device`.

All produce identical tapes; the tests cross-check them.
"""

from __future__ import annotations

from .tape import FrontendResult


def tokenize(data, bit_pos: int = 0, window_len: int = 0,
             frontend: str = "auto", device=None) -> FrontendResult:
    if frontend == "device":
        if bit_pos:
            raise ValueError("device frontend decodes whole streams "
                             "(bit_pos must be 0)")
        from .ops import tokenize_device as td
        return td.tokenize_auto(bytes(data), window_len, device=device)
    if frontend in ("auto", "native"):
        from .native import loader
        return loader.tokenize(data, bit_pos, window_len)
    if frontend != "python":
        raise ValueError(f"unknown frontend {frontend!r}")
    from . import reference
    return reference.tokenize_host(data, bit_pos, window_len)
