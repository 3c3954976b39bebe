#!/usr/bin/env python3
"""Time variants of the sequential tokenizer (tbz_torch/csrc/inflate.cu)
side by side on one CUDA card, to see where its time a token goes.

    python3 probe_inflate.py OUT_DIR [--prev OLD_INFLATE_CU]

Builds, with nvcc for sm_90a, each variant into OUT_DIR/<name>/lib.so:
  new          the tree's kernel;
  new_nostore  the same without the tape stores of the literal path;
  new_warp     the same with one warp a block (32 threads);
  prev         an older inflate.cu given with --prev (optional);
writes the tree kernel's SASS to OUT_DIR/inflate.sass (cuobjdump), and
times every variant on a 4 MiB Z_FIXED body and a 63 KB level-6 body
(seeded, tests/torch_util.py), each twice, in turns (forward, then
reverse): CUDA events around one call after a warm-up call. Prints and
writes OUT_DIR/variants.txt: ms, ns a token and the res words (equal
across variants, a check that each ran the same stream).
"""
import argparse
import ctypes
import os
import subprocess
import sys
import zlib

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "tbz_torch", "csrc")
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))
STORES = """            s.ol[R.n_tok] = 1;
            s.di[R.n_tok] = 0;
            s.rv[R.n_tok] = tbz::e_val(e);"""
NVCC = "/usr/local/cuda/bin/nvcc"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("--prev", help="an older inflate.cu to time beside")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_inflate: no CUDA device", file=sys.stderr)
        return 2
    from tbz_torch.ops import tokenize_device as TD
    from torch_util import corpus, raw_deflate
    os.makedirs(a.out, exist_ok=True)
    base = open(os.path.join(SRC, "inflate.cu")).read()
    if STORES not in base:
        raise SystemExit("the literal path's stores moved: update STORES")
    variants = {
        "new": base,
        "new_nostore": base.replace(
            STORES, "            if (R.n_tok < 0) s.ol[0] = tbz::e_val(e);"),
        "new_warp": base.replace("constexpr int THREADS = 512;",
                                 "constexpr int THREADS = 32;"),
    }
    if a.prev:
        variants["prev"] = open(a.prev).read()
    procs = {}
    for name, src in variants.items():
        d = os.path.join(a.out, name)
        os.makedirs(d, exist_ok=True)
        p = os.path.join(d, "inflate.cu")
        with open(p, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [NVCC, *ARCH, "-shared", "-Xcompiler", "-fPIC", "-I", SRC, "-o",
             os.path.join(d, "lib.so"), p],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for name, p in procs.items():
        out = p.communicate()[0].decode()
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out}")
    cubin = os.path.join(a.out, "inflate.cubin")
    subprocess.run([NVCC, *ARCH, "-cubin", "-I", SRC, "-o", cubin,
                    os.path.join(SRC, "inflate.cu")], check=True)
    with open(os.path.join(a.out, "inflate.sass"), "w") as f:
        subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", cubin],
                       stdout=f, check=True)

    dev = torch.device("cuda")
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    bodies = {"static4MiB": co.compress(corpus(7, 4 << 20)) + co.flush(),
              "L6_63KB": raw_deflate(corpus(8, 160 << 10), 6)[:63 << 10]}
    consts = TD._all_consts_on(dev)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    libs = {}
    for n in variants:
        lib = ctypes.CDLL(os.path.join(a.out, n, "lib.so"))
        lib.tbz_inflate.restype = I
        lib.tbz_inflate.argtypes = [P, L, I, I, P, L, P, P, P, P, P]
        libs[n] = lib
    lines = []
    for bname, body in bodies.items():
        w = TD.stage_words(body, dev)
        T = 1 << max(10, (8 * len(body) + 16).bit_length())
        tape = torch.zeros(3, T, dtype=torch.int32, device=dev)
        res = torch.zeros(5, dtype=torch.int32, device=dev)
        st = torch.cuda.current_stream().cuda_stream
        times, words = {}, {}
        for order in (list(variants), list(variants)[::-1]):
            for n in order:
                def call():
                    e = libs[n].tbz_inflate(
                        w.data_ptr(), w.shape[0], len(body) * 8, 0,
                        consts.data_ptr(), T, tape[0].data_ptr(),
                        tape[1].data_ptr(), tape[2].data_ptr(),
                        res.data_ptr(), st)
                    if e:
                        raise SystemExit(f"{n}: cudaError {e}")
                call()
                torch.cuda.synchronize()
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                call()
                t1.record()
                torch.cuda.synchronize()
                times.setdefault(n, []).append(t0.elapsed_time(t1))
                words[n] = res.tolist()
        for n, t in times.items():
            line = (f"{bname} {n}: {t} ms, "
                    f"{min(t) * 1e6 / words[n][0]:.1f} ns a token "
                    f"({words[n][0]} tokens, res {words[n]})")
            print(line)
            lines.append(line)
    with open(os.path.join(a.out, "variants.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
