"""Build and bind the hand-written CUDA kernels (tbz_torch/csrc/*.cu).

Each source is compiled by its own `nvcc -gencode
arch=compute_90a,code=sm_90a` process (all started together), and the
objects are linked into one shared library with a plain C interface
under tbz_torch/build/, at first use. ctypes binds it: pointers and the
stream go in as c_void_p, and every entry returns cudaGetLastError(),
which `check` turns into an exception.

Nothing is compiled or loaded at import time, so the CPU tests import
every module of the port without a CUDA toolkit.

Launch counts: every kernel wrapper calls `count(name)` exactly where it
launches its kernel, so a run can show that the main path went through
the kernels (chip_smoke.py resets and reads them).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(_HERE, "build")
_SOURCES = ("scan.cu", "tables.cu", "lanes.cu", "stitch.cu", "resolve.cu",
            "splice.cu", "crc32.cu", "adler32.cu", "inflate.cu", "spans.cu",
            "rowgather.cu")
ARCH = "arch=compute_90a,code=sm_90a"

KERNELS = ("build_flat_table", "lanes_multi", "stitch_compact",
           "splice_resolve", "resolve_core", "crc32", "adler32",
           "resolve_batch", "tokenize_device", "resolve_flat",
           "copy_rows", "rot_rows", "accum_rows", "grid_rows")

_lib = None
_lock = threading.Lock()
_launches = {k: 0 for k in KERNELS}
build_seconds: float | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "tbz_scan_scratch_ints": (_L, [_L]),
    "tbz_build_tables": (_I, [_P, _P, _L, _P, _P, _P, _P, _P, _P, _P]),
    "tbz_lanes": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                       _P, _P]),
    "tbz_stitch_scratch_ints": (_L, [_L]),
    "tbz_stitch_compact": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                                _P, _P, _P]),
    "tbz_resolve_scratch_ints": (_L, [_L, _L]),
    "tbz_resolve": (_I, [_P, _P, _P, _L, _L, _P, _L, _P, _L, _P, _P, _P,
                         _P]),
    "tbz_resolve_batch_scratch_ints": (_L, [_L, _L, _L]),
    "tbz_resolve_batch": (_I, [_P, _P, _P, _P, _L, _L, _P, _L, _P, _L, _P,
                               _P, _P, _P]),
    "tbz_splice_scratch_ints": (_L, [_L, _L]),
    "tbz_splice_resolve": (_I, [_P, _L, _P, _P, _P, _I, _P, _P, _P, _I, _L,
                                _L, _L, _P, _L, _P, _L, _P, _P, _P, _P]),
    "tbz_checksum_scratch_ints": (_L, [_L, _L]),
    "tbz_crc32_rows": (_I, [_P, _L, _L, _P, _L, _P, _P, _P, _P, _P, _P]),
    "tbz_crc32_combine": (_I, [_P, _L, _P, _P, _P]),
    "tbz_adler32_rows": (_I, [_P, _L, _L, _P, _L, _P, _P, _P, _P]),
    "tbz_adler32_combine": (_I, [_P, _L, _P, _P]),
    "tbz_inflate": (_I, [_P, _L, _I, _I, _P, _L, _P, _P, _P, _P, _P]),
    "tbz_resolve_flat_scratch_ints": (_L, [_L]),
    "tbz_resolve_flat": (_I, [_P, _P, _P, _L, _L, _L, _P, _P, _P, _L, _P, _P,
                              _P]),
    "tbz_copy_rows": (_I, [_P, _L, _P, _L, _P, _P]),
    "tbz_grid_rows": (_I, [_P, _L, _P, _L, _P, _P]),
    "tbz_rot_rows": (_I, [_P, _P, _L, _P, _L, _P, _P]),
    "tbz_accum_rows": (_I, [_P, _P, _L, _P, _L, _P, _P, _L, _P]),
}


def count(name: str) -> None:
    _launches[name] += 1


def reset_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def launch_counts() -> dict:
    return dict(_launches)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _digest() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(_SRC_DIR)):
        with open(os.path.join(_SRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _build() -> str:
    """Compile every source in parallel, link, return the .so path
    (reused while the sources' digest is unchanged)."""
    global build_seconds
    so = os.path.join(_BUILD_DIR, f"libtbz_kernels_{_digest()}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _SOURCES:
        obj = os.path.join(_BUILD_DIR, src.replace(".cu", ".o"))
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-c",
             "-Xcompiler", "-fPIC", "-o", obj,
             os.path.join(_SRC_DIR, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    errors = []
    for src, p in zip(_SOURCES, procs):
        out, _ = p.communicate(timeout=600)
        if p.returncode:
            errors.append(f"{src}:\n{out.decode(errors='replace')}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = so + ".tmp"
    r = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                       capture_output=True, timeout=600)
    if r.returncode:
        raise RuntimeError("nvcc link failed:\n"
                           + r.stdout.decode(errors="replace")
                           + r.stderr.decode(errors="replace"))
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    return so


def lib():
    """The loaded kernel library (built on first use). Once it is
    loaded no lock is taken: _lib is set only after every signature."""
    global _lib
    loaded = _lib
    if loaded is not None:
        return loaded
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(_build())
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype = res
                fn.argtypes = args
            _lib = handle
        return _lib


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError {err}")


_raw_stream = None   # torch's raw-stream getter, found at the first call


def stream(t) -> int:
    """The raw handle of PyTorch's current stream on t's device (the
    private getter PyTorch's own generated kernels use, a few µs faster
    than building a torch.cuda.Stream, where this build has it)."""
    global _raw_stream
    if _raw_stream is None:
        import torch
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream",
                              False) or (lambda i: torch.cuda.current_stream(
                                  i).cuda_stream)
    return _raw_stream(t.get_device())


def require_cuda(*tensors) -> None:
    """Validate a kernel's inputs: all on one CUDA device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel input on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel input must be contiguous")
