#!/usr/bin/env python3
"""Time the row-gather probes copy_rows, grid_rows, rot_rows and
accum_rows (tbz_torch/csrc/rowgather.cu) of several trees of this
repository side by side on one CUDA card, or sweep this tree's design
constants.

    python3 probe_rowgather.py OUT_DIR TREE [TREE ...]
    python3 probe_rowgather.py OUT_DIR --sweep
    python3 probe_rowgather.py OUT_DIR --phases

With trees, in the order given (e.g. a parent tree, this tree, this
tree, the parent), for each tree:
  - its CLI, `python -m tbz_torch.ops.rowgather {copy|grid|rot|accum}
    N R` run from the tree, at N=8192, R=4096 and N=2^22, R=2^20 (its
    output lines kept as they are);
  - a child process that imports the tree's tbz_torch and measures the
    four probes on the spike's seeded inputs at both shapes, the same
    way for every tree, each first held equal to the tree's plain
    version: CUDA events around 10 calls after a warm-up call and a
    synchronize (chip_smoke.py phase 10's timing), the same of the
    library call (index_select for copy and grid; zeros, index_select
    and index_add_ for accum, chip_smoke.py's; none for rot), then ten
    turns of 100 calls of the probe and 100 of the library call, which
    goes first alternating (each between CUDA events: at N=8192 the
    calls are host-bound, and 10 calls do not resolve 1-2 µs a call;
    for rot ten turns of the probe alone), torch.profiler's device time
    of one call of each (the kernel alone: the tree's
    rowgather.profile_ms) and the host time of each piece of the
    wrapper's glue (rowgather.glue_us); for a tree whose CLI predates
    those two, the probe's own copies (copy and grid only).
With --sweep: builds (nvcc, sm_90a, all at once) variants of this tree's
rowgather.cu with other COPY_U / COPY_THREADS and GRID_STAGES /
STORE_LAG, and times each variant's four kernels at both shapes (events
around 10 calls at N=2^22, torch.profiler at N=8192), twice, in turns
(forward, then reverse), every output held equal to the plain
version's.
With --phases: where accum_rows' time goes. Builds this tree's
rowgather.cu again with the accum_rows kernel (one round) ending
after each of its grid barriers in turn (phases 0, A, B, C, D; see the
source), times each cut at both shapes (events around 100 calls, three
times; each cut's time less the one before is that phase's), and times
random 4-byte L2 operations (RED, returning atomicAdd, store, load; 2^22
of them into 16 MB, at random addresses and at sorted ones), the unit
the sort phases are made of.
Prints the card's name and power limit and one JSON line a tree or
variant, and writes them all to OUT_DIR/probe_rowgather*.json. Needs a
CUDA card (about 10 minutes for four trees).
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((8192, 4096), (1 << 22, 1 << 20))
PROBES = ("copy", "grid", "rot", "accum")
NVCC = "/usr/local/cuda/bin/nvcc"


def _events_ms(fn, reps: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def _profile_before(fn) -> dict:
    """rowgather.profile_ms, for a tree whose CLI predates it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t and ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.key[:60]] = t / 1e3
    return out


def _glue_before(which: str, t: dict, reps: int = 200) -> dict:
    """rowgather.glue_us's pieces, for a tree whose CLI predates it: its
    copy_rows C entry takes rows a block, and grid_rows is that entry at
    one row a block."""
    import torch
    from tbz_torch import _cuda
    from tbz_torch.ops import rowgather as RG
    idx, tbl = t["idx"], t["tbl"]
    out = tbl.new_empty(idx.shape[0], 32)
    st, fn = _cuda.stream(out), _cuda.lib().tbz_copy_rows
    per = 1 if which == "grid" else 8
    pieces = {
        "new_empty": lambda: tbl.new_empty(idx.shape[0], 32),
        "lib": _cuda.lib,
        "stream": lambda: _cuda.stream(out),
        "c_entry": lambda: fn(idx.data_ptr(), idx.shape[0], tbl.data_ptr(),
                              tbl.shape[0], per, out.data_ptr(), st),
        "call": lambda: RG.call(which, t),
        "index_select": lambda: torch.index_select(tbl, 0, idx),
    }
    res = {}
    for k, f in pieces.items():
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        res[k] = (time.perf_counter() - t0) * 1e6 / reps
        torch.cuda.synchronize()
    return res


def _library(which: str, t: dict):
    """The one PyTorch call of probe `which`'s function (chip_smoke.py
    phase 10's), or None (rot)."""
    import torch
    if which == "rot":
        return None
    if which == "accum":
        return lambda: torch.zeros(
            t["idx"].shape[0], 32, dtype=torch.int32, device="cuda"
        ).index_add_(0, t["dst"], torch.index_select(t["tbl"], 0, t["idx"]))
    return lambda: torch.index_select(t["tbl"], 0, t["idx"])


def _plain(RG, which: str, t: dict):
    if which == "rot":
        return RG._rot_rows_plain(t["idx"], t["rot"], t["tbl"])
    if which == "accum":
        return RG._accum_rows_plain(t["idx"], t["dst"], t["tbl"])
    return RG._copy_rows_plain(t["idx"], t["tbl"])


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch
    import tbz_torch
    from tbz_torch.ops import rowgather as RG
    assert os.path.dirname(os.path.dirname(tbz_torch.__file__)) == tree
    profile = getattr(RG, "profile_ms", _profile_before)
    glue = getattr(RG, "glue_us", _glue_before)
    every_glue = hasattr(RG, "accum_scratch_ints")   # glue_us of all four
    out = {"tree": tree}
    for N, R in SHAPES:
        for which in PROBES:
            t = RG.to_tensors(RG.probe_inputs(which, N, R), "cuda")
            assert torch.equal(RG.call(which, t), _plain(RG, which, t))
            lib_call = _library(which, t)
            ours = lambda: RG.call(which, t)  # noqa: E731
            turns = []
            for k in range(10):   # which goes first alternates
                if lib_call is None:
                    turns.append((_events_ms(ours, 100), None))
                    continue
                pair = (ours, lib_call) if k % 2 == 0 else (lib_call, ours)
                x, y = (_events_ms(f, 100) for f in pair)
                turns.append((x, y) if k % 2 == 0 else (y, x))
            r = {"ms": _events_ms(ours),
                 "turns_100_ms": [a for a, _ in turns],
                 "alone": profile(ours)}
            if lib_call is not None:
                r.update(library_ms=_events_ms(lib_call),
                         turns_100_library_ms=[b for _, b in turns],
                         library_alone=profile(lib_call))
            if which in ("copy", "grid") or every_glue:
                r["glue_us"] = glue(which, t)
            out[f"{which}/{N}"] = r
            del t
    return out


def cli_runs(tree: str) -> list:
    lines = []
    for N, R in SHAPES:
        for which in PROBES:
            r = subprocess.run([sys.executable, "-m", "tbz_torch.ops.rowgather",
                                which, str(N), str(R)], cwd=tree,
                               capture_output=True, text=True, timeout=600)
            if r.returncode:
                raise RuntimeError(f"{tree} CLI {which} {N}: "
                                   f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
            lines += r.stdout.strip().splitlines()
    return lines


VARIANTS = {   # name -> {constant: value}; "kept" is the tree's own
    "kept": {},
    "copy_u4": {"COPY_U": 4}, "copy_u16": {"COPY_U": 16},
    "copy_t128": {"COPY_THREADS": 128}, "copy_t512": {"COPY_THREADS": 512},
    "copy_u16_t512": {"COPY_U": 16, "COPY_THREADS": 512},
    "copy_u4_t512": {"COPY_U": 4, "COPY_THREADS": 512},
    "grid_s4": {"GRID_STAGES": 4}, "grid_s10": {"GRID_STAGES": 10},
    "grid_s8_lag2": {"STORE_LAG": 2}, "grid_s10_lag2": {"GRID_STAGES": 10,
                                                         "STORE_LAG": 2},
    "grid_s4_lag2": {"GRID_STAGES": 4, "STORE_LAG": 2},
}


def sweep(out_dir: str) -> list:
    import torch
    src_dir = os.path.join(HERE, "tbz_torch", "csrc")
    base = open(os.path.join(src_dir, "rowgather.cu")).read()
    work = tempfile.mkdtemp()   # the variants' builds (not brought back)
    procs = {}
    for name, consts in VARIANTS.items():
        text = base
        for k, v in consts.items():
            text, n = re.subn(rf"constexpr int {k} = \d+;",
                              f"constexpr int {k} = {v};", text)
            assert n == 1, k
        d = os.path.join(work, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "rowgather.cu"), "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             "-I", src_dir, "-o", os.path.join(d, "lib.so"),
             os.path.join(d, "rowgather.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ptxas = {}
    for name, p in procs.items():
        text, _ = p.communicate(timeout=600)
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{text.decode()}")
        ptxas[name] = [ln for ln in text.decode().splitlines()
                       if "registers" in ln or "smem" in ln]
    P, L, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    from tbz_torch.ops import rowgather as RG
    inputs = {}   # (probe, N) -> (tensors, plain result)
    for N, R in SHAPES:
        for which in ("copy", "rot", "accum"):
            t = RG.to_tensors(RG.probe_inputs(which, N, R), "cuda")
            inputs[which, N] = (t, _plain(RG, which, t))
    inputs.update({("grid", N): inputs["copy", N] for N, _ in SHAPES})
    argtypes = {"copy": [P, L, P, L, P, P], "grid": [P, L, P, L, P, P],
                "rot": [P, P, L, P, L, P, P],
                "accum": [P, P, L, P, L, P, P, L, P]}
    calls, rows = {}, {}
    for name in VARIANTS:   # load and check every variant
        so = ctypes.CDLL(os.path.join(work, name, "lib.so"))
        rows[name] = {"variant": name, "consts": VARIANTS[name],
                      "ptxas": ptxas[name]}
        for (which, N), (t, want) in inputs.items():
            kern = which + "_rows"
            fn = getattr(so, "tbz_" + kern)
            fn.restype, fn.argtypes = I, argtypes[which]
            bufs = [torch.empty_like(want)]   # out (and the scratch)
            vecs = [t["idx"]] + [t[k] for k in ("rot", "dst") if k in t]
            args = [*(v.data_ptr() for v in vecs), N, t["tbl"].data_ptr(),
                    t["tbl"].shape[0], bufs[0].data_ptr()]
            if which == "accum":
                bufs.append(torch.empty(RG.accum_scratch_ints(N),
                                        dtype=torch.int32, device="cuda"))
                args += [bufs[1].data_ptr(), bufs[1].numel()]
            st = torch.cuda.current_stream().cuda_stream

            def go(fn=fn, args=args, st=st, k=kern, v=name, bufs=bufs):
                err = fn(*args, st)
                if err:
                    raise RuntimeError(f"{v} {k}: cudaError {err}")

            go()
            torch.cuda.synchronize()
            assert torch.equal(bufs[0], want), (name, kern, N)
            calls[name, kern, N] = go
            rows[name][f"{kern}/{N}"] = []
    order = list(VARIANTS)
    for names in (order, order[::-1]):   # two passes, in turns
        for name in names:
            for (v, kern, N), go in calls.items():
                if v == name:
                    rows[name][f"{kern}/{N}"].append(
                        _events_ms(go) if N == SHAPES[-1][0]
                        else sum(RG.profile_ms(go).values()))
    shutil.rmtree(work, ignore_errors=True)
    for name in order:
        print(json.dumps(rows[name]), flush=True)
    return [rows[n] for n in order]


L2_OPS = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#define LOOP for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; \
                  i < N; i += (int64_t)gridDim.x * blockDim.x)
__global__ void red(const int* d, int64_t N, int* c, int* o) {
  LOOP atomicAdd(c + __ldg(d + i), 1);
}
__global__ void atom(const int* d, int64_t N, int* c, int* o) {
  LOOP o[i] = atomicAdd(c + __ldg(d + i), 1);
}
__global__ void store(const int* d, int64_t N, int* c, int* o) {
  LOOP c[__ldg(d + i)] = (int)i;
}
__global__ void load(const int* d, int64_t N, int* c, int* o) {
  LOOP o[i] = __ldcg(c + __ldg(d + i));
}
extern "C" int l2_op(int k, const int* d, int64_t N, int* c, int* o,
                     cudaStream_t s) {
  void (*f[])(const int*, int64_t, int*, int*) = {red, atom, store, load};
  f[k]<<<132 * 8, 256, 0, s>>>(d, N, c, o);
  return (int)cudaGetLastError();
}
"""


def phases(out_dir: str) -> dict:
    """--phases: accum_rows cut after each grid barrier, and random L2
    operations (see the module's docstring)."""
    import numpy as np
    import torch
    from tbz_torch.ops import rowgather as RG
    src_dir = os.path.join(HERE, "tbz_torch", "csrc")
    text = open(os.path.join(src_dir, "rowgather.cu")).read()
    a = text.index("    accum_rows(const int32_t")
    b = text.index("\n}\n", a)
    body = text[a:b].split("grid.sync();")
    names = ["0", "A", "B", "C", "D"][:len(body) - 1]
    work = tempfile.mkdtemp()
    procs = {}
    for k in range(len(names) + 1):   # k: return after barrier k; 0: none
        cut = body[0] + "".join(
            "grid.sync();" + ("return;" if j + 1 == k else "") + part
            for j, part in enumerate(body[1:]))
        with open(os.path.join(work, f"cut{k}.cu"), "w") as f:
            f.write(text[:a] + cut + text[b:])
    with open(os.path.join(work, "l2.cu"), "w") as f:
        f.write(L2_OPS)
    for name in [f"cut{k}" for k in range(len(names) + 1)] + ["l2"]:
        procs[name] = subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", src_dir, "-o",
             os.path.join(work, name + ".so"),
             os.path.join(work, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for name, p in procs.items():
        out, _ = p.communicate(timeout=600)
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out.decode()}")
    P, L, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    st = torch.cuda.current_stream().cuda_stream
    res = {"phases": names, "cuts_ms": {}, "l2_ops_us": {}}
    for N, R in SHAPES:
        t = RG.to_tensors(RG.probe_inputs("accum", N, R), "cuda")
        out = torch.empty(N, 32, dtype=torch.int32, device="cuda")
        ws = torch.empty(RG.accum_scratch_ints(N), dtype=torch.int32,
                         device="cuda")
        for k in range(len(names) + 1):
            so = ctypes.CDLL(os.path.join(work, f"cut{k}.so"))
            fn = so.tbz_accum_rows
            fn.restype, fn.argtypes = I, [P, P, L, P, L, P, P, L, P]
            args = (t["idx"].data_ptr(), t["dst"].data_ptr(), N,
                    t["tbl"].data_ptr(), R, out.data_ptr(), ws.data_ptr(),
                    ws.numel(), st)

            def go(fn=fn, args=args):
                if fn(*args):
                    raise RuntimeError("accum_rows cut: launch refused")

            label = f"to {names[k - 1]}" if k else "all"
            res["cuts_ms"][f"{N} {label}"] = [_events_ms(go, 100)
                                              for _ in range(3)]
            if k == 0:
                assert torch.equal(out, RG._accum_rows_plain(
                    t["idx"], t["dst"], t["tbl"]))
        del t, out, ws
    so = ctypes.CDLL(os.path.join(work, "l2.so"))
    so.l2_op.restype, so.l2_op.argtypes = I, [I, P, L, P, P, P]
    n = 1 << 22
    d = torch.from_numpy(np.random.default_rng(0).integers(0, n, n).astype(
        np.int32)).cuda()
    c, o = torch.zeros_like(d), torch.empty_like(d)
    for order, dd in (("random", d), ("sorted", torch.sort(d).values)):
        for k, op in enumerate(("red", "atomic", "store", "load")):
            res["l2_ops_us"][f"{op} {order}"] = 1e3 * _events_ms(
                lambda: so.l2_op(k, dd.data_ptr(), n, c.data_ptr(),
                                 o.data_ptr(), st), 50)
    shutil.rmtree(work, ignore_errors=True)
    for k, v in res["cuts_ms"].items():
        print(f"accum_rows {k}: " + " ".join(f"{x:.4f}" for x in v), flush=True)
    for k, v in res["l2_ops_us"].items():
        print(f"2^22 L2 ops, {k}: {v:.1f} us", flush=True)
    return res


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(measure(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("probe_rowgather: no CUDA device", file=sys.stderr)
        return 2
    out_dir = sys.argv[1]
    os.makedirs(out_dir, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    if sys.argv[2] == "--sweep":
        res = {"device": smi, "sweep": sweep(out_dir)}
        name = "probe_rowgather_sweep.json"
    elif sys.argv[2] == "--phases":
        res = dict(phases(out_dir), device=smi)
        name = "probe_rowgather_phases.json"
    else:
        runs = []
        for tree in (os.path.abspath(t) for t in sys.argv[2:]):
            lines = cli_runs(tree)
            for ln in lines:
                print(f"  {os.path.relpath(tree, HERE)}: {ln}", flush=True)
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--one", tree], capture_output=True,
                               text=True, timeout=600)
            if r.returncode:
                print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
                return 1
            runs.append(dict(json.loads(r.stdout.strip().splitlines()[-1]),
                             cli=lines))
            print(json.dumps(runs[-1]), flush=True)
        res = {"device": smi, "runs": runs}
        name = "probe_rowgather.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
