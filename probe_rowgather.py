#!/usr/bin/env python3
"""Time the row-gather probes copy_rows and grid_rows
(tbz_torch/csrc/rowgather.cu) of several trees of this repository side
by side on one CUDA card, or sweep this tree's design constants.

    python3 probe_rowgather.py OUT_DIR TREE [TREE ...]
    python3 probe_rowgather.py OUT_DIR --sweep

With trees, in the order given (e.g. a parent tree, this tree, this
tree, the parent), for each tree:
  - its CLI, `python -m tbz_torch.ops.rowgather {copy|grid} N R` run
    from the tree, at N=8192, R=4096 and N=2^22, R=2^20 (its output
    lines kept as they are);
  - a child process that imports the tree's tbz_torch and measures both
    probes on the spike's seeded inputs at both shapes, the same way for
    every tree: CUDA events around 10 calls after a warm-up call and a
    synchronize (chip_smoke.py phase 10's timing), the same of
    index_select, then ten turns of 100 calls of the probe and 100 of
    index_select, which goes first alternating (each between CUDA
    events: at N=8192 both calls are host-bound, and 10 calls do not
    resolve 1-2 µs a call), torch.profiler's device time of one call of
    each (the kernel alone: the tree's rowgather.profile_ms) and the
    host time of each piece of the wrapper's glue (rowgather.glue_us);
    for a tree whose CLI predates those two, the probe's own copies.
With --sweep: builds (nvcc, sm_90a, all at once) variants of this tree's
rowgather.cu with other COPY_U / COPY_THREADS and GRID_STAGES /
STORE_LAG, and times each variant's kernels at both shapes (events
around 10 calls at N=2^22, torch.profiler at N=8192), twice, in turns
(forward, then reverse), every output held equal to index_select's.
Prints the card's name and power limit and one JSON line a tree or
variant, and writes them all to OUT_DIR/probe_rowgather.json. Needs a
CUDA card (about 2 minutes for four trees).
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
PROBES = ("copy", "grid")
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


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch
    import tbz_torch
    from tbz_torch.ops import rowgather as RG
    assert os.path.dirname(os.path.dirname(tbz_torch.__file__)) == tree
    profile = getattr(RG, "profile_ms", _profile_before)
    glue = getattr(RG, "glue_us", _glue_before)
    out = {"tree": tree}
    for N, R in SHAPES:
        for which in PROBES:
            t = RG.to_tensors(RG.probe_inputs(which, N, R), "cuda")
            idx, tbl = t["idx"], t["tbl"]
            assert torch.equal(RG.call(which, t),
                               torch.index_select(tbl, 0, idx))
            lib_call = lambda: torch.index_select(tbl, 0, idx)  # noqa: E731
            ours = lambda: RG.call(which, t)  # noqa: E731
            turns = []
            for k in range(10):   # which goes first alternates
                pair = (ours, lib_call) if k % 2 == 0 else (lib_call, ours)
                x, y = (_events_ms(f, 100) for f in pair)
                turns.append((x, y) if k % 2 == 0 else (y, x))
            out[f"{which}/{N}"] = {
                "ms": _events_ms(ours),
                "index_select_ms": _events_ms(lib_call),
                "turns_100_ms": [a for a, _ in turns],
                "turns_100_index_select_ms": [b for _, b in turns],
                "alone": profile(ours),
                "index_select_alone": profile(lib_call),
                "glue_us": glue(which, t)}
            del t, idx, tbl
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
    inputs = {}
    from tbz_torch.ops import rowgather as RG
    for N, R in SHAPES:
        t = RG.to_tensors(RG.probe_inputs("copy", N, R), "cuda")
        inputs[N] = (t["idx"], t["tbl"], torch.index_select(t["tbl"], 0,
                                                            t["idx"]))
    calls, rows = {}, {}
    for name in VARIANTS:   # load and check every variant
        so = ctypes.CDLL(os.path.join(work, name, "lib.so"))
        rows[name] = {"variant": name, "consts": VARIANTS[name],
                      "ptxas": ptxas[name]}
        for kern in ("copy_rows", "grid_rows"):
            fn = getattr(so, "tbz_" + kern)
            fn.restype, fn.argtypes = I, [P, L, P, L, P, P]
            for N, (idx, tbl, want) in inputs.items():
                o = torch.empty_like(want)
                st = torch.cuda.current_stream().cuda_stream

                def go(fn=fn, idx=idx, tbl=tbl, o=o, st=st, N=N, k=kern,
                       v=name):
                    err = fn(idx.data_ptr(), N, tbl.data_ptr(), tbl.shape[0],
                             o.data_ptr(), st)
                    if err:
                        raise RuntimeError(f"{v} {k}: cudaError {err}")

                go()
                torch.cuda.synchronize()
                assert torch.equal(o, want), (name, kern, N)
                calls[name, kern, N] = go
                rows[name][f"{kern}/{N}"] = []
    order = list(VARIANTS)
    for names in (order, order[::-1]):   # two passes, in turns
        for name in names:
            for (v, kern, N), go in calls.items():
                if v == name:
                    rows[name][f"{kern}/{N}"].append(
                        _events_ms(go) if N == max(inputs)
                        else sum(RG.profile_ms(go).values()))
    shutil.rmtree(work, ignore_errors=True)
    for name in order:
        print(json.dumps(rows[name]), flush=True)
    return [rows[n] for n in order]


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
